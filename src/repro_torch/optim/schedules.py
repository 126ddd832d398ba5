"""Learning-rate schedules: scalar functions of the step (the reference's
``repro.optim.schedules``).

Each returns a float32 0-dim tensor on the CPU, computed in float32 as the
reference computes it, so a schedule's value is known on the host without
reading the card.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine(lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return fn


def inverse_sqrt(lr: float, warmup: int):
    def fn(step):
        step = _f32(step)
        return lr * torch.minimum(step / max(warmup, 1),
                                  torch.sqrt(max(warmup, 1) / torch.clamp(step, min=1)))

    return fn
