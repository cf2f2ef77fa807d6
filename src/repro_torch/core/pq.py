"""Product quantization (Jégou et al., TPAMI'11) for the IVFPQ payload.

Vectors are encoded as residuals against their coarse centroid (Faiss IVFPQ
semantics): ``code = PQ(y - c_k)``.  Search builds a per-(query, probe)
asymmetric-distance table (LUT) and accumulates it over the candidate codes
(ADC).  Same names, shapes and arithmetic as the JAX package's
``repro.core.pq``.

``adc_accumulate`` adds the M table entries in the order j = 0..M-1 (the
order of the ADC kernels), so on the card the kernel path
(``pq_score_fn(use_kernel=True)``, ``csrc/pq_adc.cu``) and the plain path
agree bit for bit; the reference's ``jnp.sum`` may add in another order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.block_pool import IVFState
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels import ops, ref

KSUB = 256  # codewords per subquantizer (uint8 codes)


@dataclasses.dataclass(frozen=True)
class PQParams:
    codebooks: torch.Tensor  # [M, KSUB, dsub] f32

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def pq_from_host(codebooks: np.ndarray, device) -> PQParams:
    """Codebooks trained elsewhere (``np.asarray(pq.codebooks)`` of either
    package) on ``device``."""
    books = torch.from_numpy(np.array(codebooks, dtype=np.float32, order="C"))
    if books.dim() != 3 or books.shape[1] != KSUB:
        raise ValueError(f"codebooks must be [M, {KSUB}, dsub], got {tuple(books.shape)}")
    return PQParams(codebooks=books.to(device))


def train_pq(
    residuals: np.ndarray, m: int, *, n_iter: int = 15, seed: int = 0,
    device="cuda",
) -> PQParams:
    """Train per-subspace codebooks on (sampled) residual vectors."""
    residuals = np.asarray(residuals, np.float32)
    n, d = residuals.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    dsub = d // m
    books = np.zeros((m, KSUB, dsub), np.float32)
    for j in range(m):
        sub = residuals[:, j * dsub : (j + 1) * dsub]
        books[j] = kmeans(sub, KSUB, n_iter=n_iter, seed=seed + j, device=device)
    return PQParams(codebooks=torch.from_numpy(books).to(device))


def encode(pq: PQParams, residuals: torch.Tensor) -> torch.Tensor:
    """residuals [B, D] -> codes [B, M] uint8 (argmin per subspace; ties go
    to the lower codeword)."""
    b, _ = residuals.shape
    sub = residuals.reshape(b, pq.m, pq.dsub)
    dots = torch.einsum("bmd,mkd->bmk", sub, pq.codebooks)  # [B, M, KSUB]
    cn = torch.sum(pq.codebooks * pq.codebooks, dim=-1)  # [M, KSUB]
    d2 = cn[None] - 2.0 * dots
    return torch.argmin(d2, dim=-1).to(torch.uint8)


def decode(pq: PQParams, codes: torch.Tensor) -> torch.Tensor:
    """codes [..., M] -> reconstructed residuals [..., D]."""
    sub = torch.arange(pq.m, device=codes.device)
    recon = pq.codebooks[sub, codes.long()]  # [..., M, dsub]
    return recon.reshape(*codes.shape[:-1], pq.dim)


def adc_lut(pq: PQParams, query_residuals: torch.Tensor) -> torch.Tensor:
    """query residuals [..., D] -> LUT [..., M, KSUB] of squared L2 terms."""
    sub = query_residuals.reshape(*query_residuals.shape[:-1], pq.m, pq.dsub)
    dots = torch.einsum("...md,mkd->...mk", sub, pq.codebooks)
    cn = torch.sum(pq.codebooks * pq.codebooks, dim=-1)
    qn = torch.sum(sub * sub, dim=-1)  # [..., M]
    return qn[..., None] + cn - 2.0 * dots


def adc_accumulate(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [..., M, KSUB], codes [..., T, M] -> distances [..., T]."""
    return ref.pq_adc_ref(lut, codes)


def make_pq_encode_fn(pq: PQParams):
    """encode(state, assign, vectors) hook for ``make_insert_fn`` and
    ``make_update_fn``."""

    def _encode(state: IVFState, assign: torch.Tensor, vectors: torch.Tensor):
        residuals = vectors - state.centroids[assign.long()]
        return encode(pq, residuals)

    return _encode


def probe_residual_luts(
    pq: PQParams, centroids: torch.Tensor, queries: torch.Tensor,
    probe_idx: torch.Tensor,
) -> torch.Tensor:
    """LUT-building prologue shared by every ADC scorer: queries [Q, D],
    probe_idx [Q, NP] -> [Q, NP, M, KSUB] ADC tables of the query residual
    against each probed centroid (distances are computed in residual space
    per probe)."""
    qres = queries[:, None, :] - centroids[probe_idx.long()]  # [Q, NP, D]
    return adc_lut(pq, qres)


def pq_score_fn(pq: PQParams, use_kernel: bool = False):
    """score_fn hook for ``search.py``: ADC over candidate block codes.

    payload: [Q, C, T, M] uint8 codes where C = nprobe * chain (block-table
    path) or C = nprobe (chain-walk path); probe_idx: [Q, nprobe].  The
    centroids come from the ``state`` argument, so a cached search step
    never holds a stale copy.  ``use_kernel=True`` sums through
    ``ops.pq_adc`` (the CUDA kernel on a CUDA tensor), ``False`` through
    the plain ``adc_accumulate``."""

    def _score(state: IVFState, queries, payload, probe_idx):
        q, c, t, m = payload.shape
        nprobe = probe_idx.shape[1]
        chain = c // nprobe
        lut = probe_residual_luts(pq, state.centroids, queries, probe_idx)
        codes = payload.reshape(q, nprobe, chain * t, m)
        if use_kernel:
            d = ops.pq_adc(lut.reshape(q * nprobe, pq.m, KSUB).contiguous(),
                           codes.reshape(q * nprobe, chain * t, m).contiguous())
            d = d.reshape(q, nprobe, chain * t)
        else:
            d = adc_accumulate(lut, codes)  # [Q, NP, chain*T]
        return d.reshape(q, c, t)

    return _score
