"""Paged-KV LM serving: the paper's memory-block pool applied to decode
(the reference's ``repro.serving.paged_lm``).

A KV cache grows token by token as an IVF list grows vector by vector, so
it lives in the same kind of pool: fixed blocks of T positions, a bump
allocator (``cur_p``), and a per-sequence block table.  Appends are O(1)
and copy nothing; decode attention reads through the table with the
hand-written ``paged_decode_attention`` kernel (``kernels/ops.py``: the
kernel on a CUDA tensor, its plain version on a CPU tensor).

The step writes each new K/V row into the pools in place, as
``core/insert.py`` writes the IVF pool; the reference instead returns a
new state from a donated jit step.  Out-of-range indices follow the
reference: a sequence past ``max_blocks_per_seq * T`` positions gets no
new table entry (JAX drops the scatter) and writes its token into its
last block (JAX clamps the gather).  A block id past the pool, which the
reference would write into its table and then read clamped, raises here.

A step appends one position to every sequence, so all B lengths stay
equal.  The state mirrors that length on the host (``n_pos``), and the
step decides from it, without reading the card, whether this step
allocates and whether the pool holds the new blocks: the host can queue
the next step while the card still runs this one.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ivf import _resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import _qkv, rmsnorm
from repro_torch.models.transformer import LMConfig, _ffn, layer_views

NULL = -1


@dataclasses.dataclass(frozen=True)
class PagedKVState:
    k_pool: torch.Tensor  # [L, P, T, KV, dh]
    v_pool: torch.Tensor  # [L, P, T, KV, dh]
    block_tables: torch.Tensor  # [B, NB] i32 (shared across layers)
    seq_lens: torch.Tensor  # [B] i32
    cur_p: torch.Tensor  # [] i32 bump pointer (the IVF pool's discipline)
    n_pos: int = 0  # host mirror of seq_lens: every sequence holds n_pos


def init_paged_kv(
    cfg: LMConfig,
    batch: int,
    *,
    n_blocks: int,
    block_size: int,
    max_blocks_per_seq: int,
    dtype=None,
    device=None,
) -> PagedKVState:
    """An empty cache on ``device`` (``cuda`` unless the caller passes
    another)."""
    dtype = dtype or cfg.dtype
    dev = _resolve_device(device)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.d_head)
    return PagedKVState(
        k_pool=torch.zeros(shape, dtype=dtype, device=dev),
        v_pool=torch.zeros(shape, dtype=dtype, device=dev),
        block_tables=torch.full((batch, max_blocks_per_seq), NULL,
                                dtype=torch.int32, device=dev),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=dev),
        cur_p=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _alloc_blocks(state: PagedKVState, t: int) -> PagedKVState:
    """Bump-allocate one block for every sequence whose next token starts a
    block (the IVF insert allocator, Alg. 2 line 13).  A sequence past its
    table's last column still takes a block id from the pointer, but no
    table entry, as the reference's dropped scatter does."""
    lens = state.seq_lens
    needs = (lens % t == 0).to(torch.int32)
    new_blk = state.cur_p + torch.cumsum(needs, 0, dtype=torch.int32) - needs
    nb = state.block_tables.shape[1]
    cols = torch.arange(nb, device=lens.device)[None, :]
    write = (needs[:, None] == 1) & (cols == (lens // t)[:, None])  # [B, NB]
    tables = torch.where(write, new_blk[:, None], state.block_tables)
    return dataclasses.replace(
        state, block_tables=tables, cur_p=state.cur_p + needs.sum(dtype=torch.int32),
    )


def paged_decode_step(
    params: dict,
    cfg: LMConfig,
    token: torch.Tensor,  # [B] i32
    state: PagedKVState,
):
    """One decode step over the block-pool cache: allocate, write each
    layer's new K/V in place, attend through the tables.  Returns
    (logits [B, V], state'); state' shares the pools with ``state``."""
    b = token.shape[0]
    acfg = cfg.attn_config()
    p, t = state.k_pool.shape[1:3]
    nb = state.block_tables.shape[1]
    # the schedule on the host: at n_pos % t == 0 every sequence takes
    # the next block, ids cur_p .. cur_p + b - 1 with cur_p = b * n_pos / t,
    # and a table entry while n_pos // t < nb
    col = state.n_pos // t
    if state.n_pos % t == 0 and col < nb and b * (col + 1) > p:
        raise RuntimeError(
            f"paged KV pool exhausted: a sequence needs a block past the "
            f"pool's {p} (the reference would read a clamped block)"
        )
    state = _alloc_blocks(state, t)
    lens = state.seq_lens
    seq = torch.arange(b, device=lens.device)
    # past its table's end a sequence writes into its last block, as the
    # reference's clamped gather does
    rows = state.block_tables[seq, torch.clamp(lens // t, max=nb - 1)].long()
    offs = (lens % t).long()
    new_lens = lens + 1

    x = params["embed"][token.long()][:, None].to(cfg.dtype)  # [B, 1, D]
    for i, lp in enumerate(layer_views(params)):
        kp, vp = state.k_pool[i], state.v_pool[i]  # [P, T, KV, dh] views
        xn = rmsnorm(x, lp["attn_norm"])
        q, k_new, v_new = _qkv(lp["attn"], acfg, xn, lens[:, None])
        kp[rows, offs] = k_new[:, 0].to(kp.dtype)
        vp[rows, offs] = v_new[:, 0].to(vp.dtype)
        o = ops.paged_decode_attention(
            q[:, 0].contiguous(), kp, vp, state.block_tables, new_lens
        )  # [B, H, dh]
        o = o.reshape(b, 1, cfg.n_heads * cfg.d_head) @ lp["attn"]["wo"]
        h = x + o
        y, _ = _ffn(lp, cfg, rmsnorm(h, lp["mlp_norm"]))
        x = h + y
    x = rmsnorm(x, params["final_norm"])
    logits = (x @ params["lm_head"])[:, 0]
    return logits, dataclasses.replace(state, seq_lens=new_lens, n_pos=state.n_pos + 1)


def make_paged_decode_fn(cfg: LMConfig):
    """The serving hot loop's step: ``step(params, token, state)``."""

    def step(params, token, state):
        return paged_decode_step(params, cfg, token, state)

    return step
