"""equiformer-v2 [arXiv:2306.12059]: SO(2)-eSCN equivariant graph attention
(the reference's ``repro.configs.equiformer_v2``).

Config: n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8.  The four
shapes span Cora-size full-batch, Reddit-size sampled minibatch,
ogb_products full-batch-large, and batched small molecules.
"""

import dataclasses

from repro_torch.configs.base import GNN_SHAPES, ArchSpec, register
from repro_torch.models.gnn.equiformer_v2 import EquiformerConfig

FULL = EquiformerConfig(
    name="equiformer-v2",
    n_layers=12,
    channels=128,
    l_max=6,
    m_max=2,
    n_heads=8,
    d_feat_in=128,  # overridden per shape (d_feat differs per dataset)
    n_radial=8,
    edge_chunk=262_144,
    readout="node",
    n_out=64,
)

SMOKE = dataclasses.replace(
    FULL, n_layers=2, channels=16, l_max=2, m_max=1, n_heads=4,
    d_feat_in=8, edge_chunk=64, n_out=4,
)

register(
    ArchSpec(
        arch_id="equiformer-v2",
        family="gnn",
        config=FULL,
        smoke_config=SMOKE,
        shapes=dict(GNN_SHAPES),
        source="arXiv:2306.12059 (unverified tier)",
        notes=(
            "message passing via segment_sum over edge chunks; 3D positions "
            "synthesised for citation/product graphs; paper ANNS technique "
            "inapplicable (DESIGN.md §6)."
        ),
    )
)
