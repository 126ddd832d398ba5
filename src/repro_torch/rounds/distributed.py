"""Round bodies shared by the round programs: the local-SGD scan that the
federated ``client_deltas`` run.  Single-device local-update rounds live in
:mod:`repro_torch.rounds.local_update` (their first local step keeps
robust_gd's vmap layout, which holds τ = 1 bit for bit to Algorithm 1).
The reference's ``torch.distributed`` strategies, ``make_local_update_round``
and ``one_round_distributed`` come with the multi-GPU port."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import tree_map


def scan_local_sgd(value_and_grad_fn: Callable, w, tau: int, eta):
    """τ local SGD steps from ``w`` on fixed local data: returns
    ``(delta, loss0)`` where ``delta = Σₖ gₖ`` is the accumulated local
    gradient (the transmitted round payload) and ``loss0`` the loss at the
    round's shared iterate.  ``value_and_grad_fn(p) -> (loss, grad)``
    closes over the local batch; ``w`` may be a tree of tensors."""
    if tau < 1:
        raise ValueError(f"need at least one local step, got tau={tau}")
    p, acc, loss0 = w, tree_map(torch.zeros_like, w), None
    for k in range(tau):
        loss, g = value_and_grad_fn(p)
        loss0 = loss if k == 0 else loss0
        acc = tree_map(lambda a, b: a + b, acc, g)
        p = tree_map(lambda a, b: a - eta * b, p, g)
    return acc, loss0
