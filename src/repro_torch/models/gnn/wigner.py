"""Wigner rotation matrices for real spherical harmonics, l <= L_MAX (the
reference's ``repro.models.gnn.wigner``).

eSCN (EquiformerV2's convolution) rotates every edge's irrep features into a
frame where the edge direction is the z axis; there the SO(3) tensor product
collapses to independent SO(2) mixes per |m|.

Construction, as the reference's: complex-basis angular momentum operators
Jz (diagonal) and Jy (from the ladder operators); C_l, the complex -> real
SH change of basis; the eigendecomposition Jy = V diag(m) V^H (numpy's
``eigh``).  For Euler angles

    D_real(Rz(g)) = Re( C diag(e^{+i m g}) C^H )
    D_real(Ry(b)) = Re( W diag(e^{-i m b}) W^H ),  W = C V

and the edge-alignment rotation is D(Ry(-theta)) @ D(Rz(-phi)).

The reference evaluates Re(W diag(e^{i a}) W^H) as a complex64 einsum.  The
port evaluates the same real matrix without complex tensors: with
W = A + iB,

    Re(W diag(cos a + i sin a) W^H)[p, q]
        = sum_b P[p, q, b] cos a_b + Q[p, q, b] sin a_b,
    P[p, q, b] = A_pb A_qb + B_pb B_qb,   Q[p, q, b] = A_pb B_qb - B_pb A_qb,

with P and Q formed in float64 on the host and rounded once to float32: one
[E, d] x [d, d*d] product each.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _complex_to_real_sh(l: int) -> np.ndarray:
    """Unitary C with Y_real = C @ Y_complex (Condon-Shortley phases)."""
    dim = 2 * l + 1
    c = np.zeros((dim, dim), np.complex128)
    isq2 = 1.0 / np.sqrt(2.0)
    for m in range(-l, l + 1):
        row = m + l
        if m < 0:
            c[row, l + m] = 1j * isq2
            c[row, l - m] = -1j * isq2 * (-1) ** m
        elif m == 0:
            c[row, l] = 1.0
        else:
            c[row, l - m] = isq2
            c[row, l + m] = isq2 * (-1) ** m
    return c


def _jy(l: int) -> np.ndarray:
    """Jy in the complex |l, m> basis (m = -l..l ordering)."""
    dim = 2 * l + 1
    jp = np.zeros((dim, dim), np.complex128)  # J+ |m> = c |m+1>
    for m in range(-l, l):
        jp[m + 1 + l, m + l] = np.sqrt(l * (l + 1) - m * (m + 1))
    jm = jp.conj().T
    return (jp - jm) / 2j


@functools.lru_cache(maxsize=None)
def wigner_tables(l_max: int):
    """Host precompute: per-l (W = C V, m eigenvalues, C) as numpy arrays."""
    ws, ms, cs = [], [], []
    for l in range(l_max + 1):
        c = _complex_to_real_sh(l)
        evals, v = np.linalg.eigh(_jy(l))
        # eigenvalues of Jy are exactly -l..l; snap to integers
        evals = np.round(evals).astype(np.float64)
        ws.append(c @ v)
        ms.append(evals)
        cs.append(c)
    return ws, ms, cs


def _phase_tables(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(P, Q), each [d*d, d] float64: rows (p, q), columns b (docstring)."""
    a, b = w.real, w.imag
    p = np.einsum("pb,qb->pqb", a, a) + np.einsum("pb,qb->pqb", b, b)
    q = np.einsum("pb,qb->pqb", a, b) - np.einsum("pb,qb->pqb", b, a)
    d = w.shape[0]
    return p.reshape(d * d, d), q.reshape(d * d, d)


@functools.lru_cache(maxsize=None)
def _host_rotation_tables(l_max: int):
    """Per l: (m as float32, P_z, Q_z, P_y, Q_y) with each table the
    transpose [d, d*d] float32, ready for ``cos(angles) @ table``."""
    ws, ms, cs = wigner_tables(l_max)
    out = []
    for l in range(l_max + 1):
        pz, qz = _phase_tables(cs[l])
        py, qy = _phase_tables(ws[l])
        out.append((ms[l].astype(np.float32),) + tuple(
            np.ascontiguousarray(t.T).astype(np.float32) for t in (pz, qz, py, qy)))
    return out


def cache_key(t: torch.Tensor) -> tuple:
    """Key of the per-device tensor caches: the device, and the fake-tensor
    mode where ``t`` is a fake tensor (the dry run traces under one mode a
    cell; a tensor of one mode cannot meet another's)."""
    mode = getattr(t, "fake_mode", None)
    return str(t.device), None if mode is None else id(mode)


@functools.lru_cache(maxsize=None)
def _rotation_tables(l_max: int, key: tuple):
    """``_host_rotation_tables`` as tensors, copied once per device (and
    fake mode: ``cache_key``)."""
    device = key[0]
    return [tuple(torch.from_numpy(t).to(device) for t in per_l)
            for per_l in _host_rotation_tables(l_max)]


def _rot_from_phase(m: torch.Tensor, p_t: torch.Tensor, q_t: torch.Tensor,
                    angle: torch.Tensor, sign: float) -> torch.Tensor:
    """Re( W diag(e^{sign * i m angle}) W^H ) for a batch of angles [E]:
    [E, d, d].  Rotations about z use sign=+1 with W=C; about y sign=-1
    with W=C V (the reference's conventions)."""
    a = (sign * m) * angle[:, None]  # [E, d]
    d = m.shape[0]
    return (torch.cos(a) @ p_t + torch.sin(a) @ q_t).reshape(-1, d, d)


def edge_wigner(l_max: int, edge_vec: torch.Tensor) -> list[torch.Tensor]:
    """Per-l rotation matrices aligning each edge vector to +z.

    edge_vec: [E, 3] float32.  Returns a list of [E, 2l+1, 2l+1] float32,
    l = 0..l_max.  The inverse rotation is the transpose (orthogonal).  An
    edge along +-z or of zero length gives theta 0, pi or pi/2 and phi 0
    (``r`` carries the reference's 1e-12)."""
    x, y, z = edge_vec[:, 0], edge_vec[:, 1], edge_vec[:, 2]
    r = torch.sqrt(x * x + y * y + z * z) + 1e-12
    theta = torch.arccos(torch.clamp(z / r, -1.0, 1.0))  # polar
    phi = torch.atan2(y, x)  # azimuth
    # R_align = Ry(-theta) @ Rz(-phi) maps the edge direction to +z
    out = []
    for m, pz, qz, py, qy in _rotation_tables(l_max, cache_key(edge_vec)):
        dz = _rot_from_phase(m, pz, qz, -phi, +1.0)
        dy = _rot_from_phase(m, py, qy, -theta, -1.0)
        out.append(torch.bmm(dy, dz))
    return out


def real_sph_harm_l1(vec: torch.Tensor) -> torch.Tensor:
    """l=1 real SH (unnormalised, (y, z, x) ordering), as tests use it."""
    n = vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + 1e-12)
    return torch.stack([n[..., 1], n[..., 2], n[..., 0]], dim=-1)
