"""Checkpoints with a manifest, atomic publish and retention (the
snapshot layer's storage), in the reference's on-disk layout."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorruption,
    CheckpointManager,
    tree_flatten,
    tree_unflatten,
)
