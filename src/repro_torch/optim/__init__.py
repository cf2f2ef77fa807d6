"""Optimizers of the LM trainer (the reference's ``repro.optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    OptConfig,
    adafactor_init,
    adafactor_update,
    adam8bit_init,
    adam8bit_update,
    adamw_init,
    adamw_update,
    compress_grads_bf16,
    make_optimizer,
)
