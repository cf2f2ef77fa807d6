"""Wrapper of the hand-written Hopper kernel of the PQ ADC sums
(``csrc/pq_adc.cu``).

Same arguments, shapes and result as the JAX package's
``repro.kernels.pq_adc.pq_adc``: ``[R, M, 256]`` tables and ``[R, N, M]``
uint8 codes give ``[R, N]`` float32 sums.  It serves ``pq_score_fn`` with
``use_kernel=True`` on the ``block_table`` and ``chain_walk`` PQ paths.

The wrapper takes CUDA tensors only, checks them, allocates the output,
launches on the current stream and raises if the launch returns a CUDA
error; every launch adds one to ``LAUNCHES["pq_adc"]``.
``kernels/ops.py`` picks between it and its plain version
(``ref.pq_adc_ref``) by the tensors' device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import launch

KSUB = 256
# csrc/pq_adc.cu: blocks an SM holds (its launch bounds: 256 threads of
# 64 registers), and the rows an item keeps at least where a table is cut
# (four a thread)
ADC_BLOCKS_PER_SM, ADC_MIN_ROWS = 4, 1024

LAUNCHES: dict[str, int] = {"pq_adc": 0}


def plan_adc(r: int, n: int, m: int, n_sm: int) -> dict[str, int]:
    """How ``pq_adc`` cuts its work: items (table, chunk of ``rpc`` rows),
    ``nc`` a table (more than one only where the tables are fewer than the
    blocks the SMs hold at once, and each chunk keeps ADC_MIN_ROWS rows);
    ``ipb`` consecutive items a block and ``grid`` blocks, no more than the
    SMs hold at once, so the grid runs in one wave with equal runs but the
    last; ``smem`` bytes a block (its table)."""
    smem = m * KSUB * 4
    slots = n_sm * max(1, min(ADC_BLOCKS_PER_SM, launch.SM_SHARED // (smem + 1024)))
    nc = max(1, min(n // ADC_MIN_ROWS, slots // max(r, 1)))
    rpc = -(-n // nc)
    nc = -(-n // rpc)
    items = r * nc
    ipb = -(-items // slots)
    return {"nc": nc, "rpc": rpc, "items": items, "ipb": ipb,
            "grid": -(-items // ipb), "smem": smem}


def pq_adc(
    lut: torch.Tensor,  # [R, M, 256] f32
    codes: torch.Tensor,  # [R, N, M] u8
) -> torch.Tensor:  # [R, N] f32
    """ADC sums ``out[r, n] = sum_j lut[r, j, codes[r, n, j]]``, summed in
    the order j = 0..M-1."""
    r, m, _ = lut.shape
    n = codes.shape[1]
    launch.check("lut", lut, (torch.float32,), (r, m, KSUB))
    launch.check("codes", codes, (torch.uint8,), (r, n, m))
    if m * KSUB * 4 > launch.SMEM_LIMIT:
        raise ValueError(
            f"pq_adc: an [{m}, 256] table exceeds {launch.SMEM_LIMIT} bytes"
        )
    out = torch.empty((r, n), dtype=torch.float32, device=lut.device)
    if r == 0 or n == 0:
        return out
    plan = plan_adc(r, n, m, launch.sm_count(lut.device))
    if plan["items"] >= 2**31:
        raise ValueError(f"pq_adc: {r} tables of {n} rows exceed the grid")
    # bytes a code load: 16 where every row is 16-byte aligned, else 4, else 1
    ptr = codes.data_ptr()
    ub = 16 if m % 16 == 0 and ptr % 16 == 0 else (
        4 if m % 4 == 0 and ptr % 4 == 0 else 1)
    launch.run("pq_adc", "pq_adc_f32", lut.device, lut.data_ptr(), ptr, r, n, m,
               ub, int(lut.data_ptr() % 16 == 0), plan["nc"], plan["rpc"],
               plan["ipb"], plan["grid"], out.data_ptr())
    LAUNCHES["pq_adc"] += 1
    return out
