"""The GNN family of the port: EquiformerV2 with eSCN SO(2) graph attention,
its Wigner rotations and the fanout sampler (the reference's
``repro.models.gnn``)."""
