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
_TILE = 2048  # code rows per block (csrc/pq_adc.cu kTile)

LAUNCHES: dict[str, int] = {"pq_adc": 0}


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
    if -(-n // _TILE) > 65535:
        raise ValueError(f"pq_adc: {n} codes per row exceed the grid")
    out = torch.empty((r, n), dtype=torch.float32, device=lut.device)
    if r == 0 or n == 0:
        return out
    launch.run("pq_adc", "pq_adc_f32", lut.device, lut.data_ptr(), codes.data_ptr(),
               r, n, m, out.data_ptr())
    LAUNCHES["pq_adc"] += 1
    return out
