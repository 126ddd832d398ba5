"""Tree optimizers: SGD, momentum, AdamW.

The standard update rules on trees of tensors (dicts, tuples, lists).
States are kept in float32 whatever the parameter dtype; AdamW keeps m/v,
SGD keeps nothing, momentum keeps one slot.  ``step`` is an integer
tensor (or int): AdamW's bias corrections use ``step + 1``.

Every optimizer works on *aggregated* gradients: the robust reduction
has already happened upstream, so the update is the same for every
worker.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, step):
        new = tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype), params, grads)
        return new, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(_f32_zeros, params)

    def update(grads, state, params, step):
        new_state = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        new = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype), params, new_state)
        return new, new_state

    return Optimizer(init, update)


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        return {"m": tree_map(_f32_zeros, params), "v": tree_map(_f32_zeros, params)}

    def update(grads, state, params, step):
        t = torch.as_tensor(step).cpu().to(torch.float32) + 1.0
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float() * g.float(), state["v"], grads)

        def upd(p, m, v):
            # the corrections as 0-dim tensors on the leaf's device: a true
            # division there (a host scalar would be a reciprocal multiply)
            mh = m / c1.to(m.device)
            vh = v / c2.to(v.device)
            p32 = p.float()
            p32 = p32 - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p32)
            return p32.to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float, weight_decay: float = 0.0, beta: float = 0.9) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, beta)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
