"""Embedding tables and EmbeddingBag over one stacked table (the
reference's ``repro.models.recsys.embedding``).

All fields live in ONE table ``[padded_rows, dim]`` with per-field row
offsets, as in the reference: a lookup is one gather of ``ids + offsets``
(``index_select`` on int64 rows).  ``bag_lookup`` computes what the
reference computes, not ``F.embedding_bag``: the gather of every slot
(padding ``-1`` reads row 0), the masked weighted sum, and the mean with
a floor of 1 on the weights' sum.  Both take the reference's optional
``shard`` callback (``act_embed_bag``) and gather through
``shard.run(take, ...)``: a mesh reads a row-sharded table in a form of
its own (``launch/mesh_forms.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from repro_torch.models.layers import Shard, no_shard

ROW_PAD = 512  # table rows padded to a multiple of the largest mesh size,
# as the reference pads them (its stacked table row-shards over the mesh)

# rows drawn by one ``normal_`` call: a full-size table is drawn in place,
# chunk by chunk, so no second copy of it is ever held
INIT_CHUNK_ROWS = 1 << 20

_HASH_MUL = 2654435761
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    vocab_sizes: tuple  # rows per field
    dim: int

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def padded_rows(self) -> int:
        return -(-self.total_rows // ROW_PAD) * ROW_PAD

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(
            np.int32
        )


def init_embedding(gen, spec: EmbeddingSpec, dtype=torch.float32, device=None) -> dict:
    """``{"table": [padded_rows, dim]}`` drawn N(0, 1/dim) from ``gen``
    (None on the meta device) in float32, in place, INIT_CHUNK_ROWS rows
    a call, then cast to ``dtype`` (a float32 table is not copied)."""
    table = torch.empty((spec.padded_rows, spec.dim), dtype=torch.float32, device=device)
    for lo in range(0, spec.padded_rows, INIT_CHUNK_ROWS):
        table[lo : lo + INIT_CHUNK_ROWS].normal_(0.0, spec.dim**-0.5, generator=gen)
    return {"table": table.to(dtype)}


def _offsets(spec: EmbeddingSpec, device) -> torch.Tensor:
    return torch.as_tensor(spec.offsets, dtype=torch.int64).to(device)


def take(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table rows ``rows`` [...] (int64) -> [..., dim]."""
    return table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, table.shape[1])


def lookup(params: dict, spec: EmbeddingSpec, ids: torch.Tensor,
           shard: Shard = no_shard) -> torch.Tensor:
    """ids [B, F], one in-field id per field -> [B, F, dim]."""
    table = params["table"]
    rows = ids.to(torch.int64) + _offsets(spec, table.device)[None, :]
    return shard(shard.run(take, table, rows), "act_embed_bag")


def bag_lookup(
    params: dict,
    spec: EmbeddingSpec,
    ids: torch.Tensor,  # [B, F, L] multi-hot ids, -1 = padding
    weights: torch.Tensor | None = None,  # [B, F, L] per-sample weights
    combiner: str = "sum",
    shard: Shard = no_shard,
) -> torch.Tensor:  # [B, F, dim]
    """EmbeddingBag: gather + masked weighted reduction (sum/mean)."""
    b, f, l = ids.shape
    table = params["table"]
    valid = ids >= 0
    rows = torch.where(
        valid, ids.to(torch.int64) + _offsets(spec, table.device)[None, :, None], 0
    )
    emb = shard.run(take, table, rows)
    w = valid.to(emb.dtype)
    if weights is not None:
        w = w * weights.to(emb.dtype)
    out = torch.sum(emb * w[..., None], dim=2)
    if combiner == "mean":
        out = out / torch.clamp(w.sum(dim=2), min=1.0)[..., None]
    return shard(out, "act_embed_bag")


def hash_ids(raw: torch.Tensor, vocab: int, salt: int = 0) -> torch.Tensor:
    """Cheap multiplicative hash into [0, vocab) for raw ids: the
    reference's uint32 arithmetic with wraparound, ``((raw mod 2^32 +
    salt) * 2654435761) mod 2^32 mod vocab``, computed in int64 (torch has
    no general uint32 arithmetic).  The product is split at 16 bits of the
    multiplier, so no int64 product overflows."""
    h = ((raw.to(torch.int64) & _U32) + (salt & _U32)) & _U32
    lo = h * (_HASH_MUL & 0xFFFF)
    hi = ((h * (_HASH_MUL >> 16)) & 0xFFFF) << 16
    return (((lo + hi) & _U32) % vocab).to(torch.int32)
