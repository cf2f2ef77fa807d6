"""PyTorch/CUDA port of the block-pool online IVF index (paper §3), of the
block pool applied to an LM's KV cache (paged decode of the dense and MoE
decoders), and of the LM trainer (forward, loss, optimizers, launcher).

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``configs/``, ``data/``, ``models/``, ``optim/``, ``serving/``,
``launch/``, ``obs/``, ``persist/``, ``checkpoint/``) so each module's
counterpart is easy to find.  The
port imports ``torch`` and numpy only.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on a CUDA tensor every kernel wrapper
launches its hand-written Hopper kernel (``kernels/csrc``) or raises, and on
a CPU tensor it runs the kernel's plain PyTorch version.
"""
