"""Faults planted under the timed path, each of which a training cell's
numbers have to catch: ``correct`` must come out false with any of them.

- ``unchanged``: a step that returns its state unchanged (the optimizer
  hands back the parameters and moments it was given);
- ``half_batch``: half of each worker's rows left out, the loss the mean
  over the rest;
- ``no_exchange``: the exchange between the workers left out: the update
  takes worker 0's own gradient, not the robust aggregate of all;
- ``altered``: an answer altered where it is produced: the aggregate's
  largest leaf comes out doubled.
"""
from __future__ import annotations

import contextlib
import importlib

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


@contextlib.contextmanager
def _patched(module: str, attr: str, make):
    mod = importlib.import_module(module)
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def _unchanged(real_get):
    from repro_torch.optim.optimizers import Optimizer

    def get(*args, **kwargs):
        opt = real_get(*args, **kwargs)
        return Optimizer(opt.init, lambda grads, state, params, step: (params, state))
    return get


def _half_batch(real_loss):
    def loss_fn(params, batch, cfg, *args, **kwargs):
        half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
        return real_loss(params, half, cfg, *args, **kwargs)
    return loss_fn


def _no_exchange(real_agg):
    from repro_torch.tree import tree_map

    def agg(g, *args, **kwargs):
        return tree_map(lambda x: x[0].clone(), g)
    return agg


def _altered(real_agg):
    from repro_torch.tree import tree_leaves

    def agg(*args, **kwargs):
        out = real_agg(*args, **kwargs)
        max(tree_leaves(out), key=lambda t: t.numel()).mul_(2)
        return out
    return agg


def planted(name: str):
    """A context in which the port runs with the fault ``name``."""
    if name == "unchanged":
        return _patched("repro_torch.optim.optimizers", "get_optimizer", _unchanged)
    if name == "half_batch":
        return _patched("repro_torch.models.transformer", "loss_fn", _half_batch)
    if name == "no_exchange":
        return _patched("repro_torch.rounds.distributed", "aggregate_by_strategy", _no_exchange)
    if name == "altered":
        return _patched("repro_torch.rounds.distributed", "aggregate_by_strategy", _altered)
    raise ValueError(f"no fault {name!r}; have {FAULTS}")
