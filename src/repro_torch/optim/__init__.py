"""Optimizers on trees of tensors (SGD, momentum, AdamW), applied to the
robustly aggregated gradient."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    get_optimizer,
    momentum,
    sgd,
)
