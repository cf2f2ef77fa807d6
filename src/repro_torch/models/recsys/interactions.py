"""Feature-interaction ops shared by the recsys architectures (the
reference's ``repro.models.recsys.interactions``)."""

from __future__ import annotations

import torch

from repro_torch.models.layers import _normal


def dot_interaction(feats: torch.Tensor, self_dots: bool = False) -> torch.Tensor:
    """DLRM dot interaction: pairwise dots of [B, F, D] -> [B, P], the
    upper triangle (with the diagonal if ``self_dots``) in row-major
    order, the order of ``jnp.triu_indices``."""
    f = feats.shape[1]
    dots = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = torch.triu_indices(f, f, offset=0 if self_dots else 1, device=feats.device)
    return dots[:, iu, ju]


def cross_layer(x0, x, w, b):
    """DCN-v2 full-rank cross: x_{l+1} = x0 * (W x_l + b) + x_l."""
    return x0 * (x @ w + b) + x


def cross_layer_lowrank(x0, x, u, v, b):
    """DCN-v2 low-rank cross: x0 * (U(Vx) + b) + x."""
    return x0 * ((x @ v) @ u + b) + x


def mlp(params: list, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def init_mlp_params(gen, sizes, dtype=torch.float32, device=None) -> list:
    """He-normal weights [din, dout] and zero biases, layer by layer."""
    return [
        {
            "w": _normal(gen, (din, dout), (2.0 / din) ** 0.5, dtype, device),
            "b": torch.zeros((dout,), dtype=dtype, device=device),
        }
        for din, dout in zip(sizes[:-1], sizes[1:])
    ]
