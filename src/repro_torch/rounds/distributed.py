"""Distributed round programs: the strategy dispatch over a worker axis and
the local-SGD scan (the reference's ``repro.rounds.distributed``).

- :func:`aggregate_by_strategy` — the single name -> collective dispatcher
  for the :mod:`repro_torch.core.distributed` strategies (gather /
  bucketed / chunked / psum / hierarchical), with the stateless payload
  codecs run on each worker's contribution first.  ``launch/steps.py``
  calls it; the worker axis is any
  :class:`~repro_torch.core.distributed.Collectives`.
- :func:`scan_local_sgd` — the local-SGD scan shared by the train step's
  τ > 1 rounds and the federated ``client_deltas``.

``make_local_update_round`` and ``one_round_distributed`` come with the
``torch.distributed`` slice (ROADMAP queue A item 6); single-device
local-update rounds live in :mod:`repro_torch.rounds.local_update`.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch import rng
from repro_torch.core import distributed
from repro_torch.rounds import compression as comp_lib
from repro_torch.tree import tree_leaves, tree_map

#: the codecs' key base when the caller gives none (the reference's PRNGKey(13))
_COMP_KEY = 13


def compress_workers(ax: distributed.Collectives, axis_names: Sequence[str], g, name: str,
                     comp_key=None, draw: Optional[Callable[[int], object]] = None,
                     residual=None):
    """Each worker's tree ``g`` through the codec ``name`` as ONE flat
    message (``compression.compress_tree``).  A randomized codec draws from
    the generator of (``comp_key``, worker), a shared-key codec from that
    of ``comp_key`` alone (one map for every worker); ``draw(worker)``
    injects a worker's draw instead.  With ``residual`` (varying (D,)
    error-feedback rows) returns ``(g_hat, new_residual)``, else ``g_hat``."""
    names = tuple(axis_names)
    spec = comp_lib.get_compression(name)
    base = _COMP_KEY if comp_key is None else comp_key
    dev = tree_leaves(g)[0].device

    def one(w, tree, *res):
        gen = None
        if draw is None and spec.randomized:
            gen = rng.generator(base, w, device=dev)
        elif draw is None and spec.shared_key:
            gen = rng.generator(base, device=dev)
        hat, new = comp_lib.compress_tree(name, tree, generator=gen,
                                          draw=None if draw is None else draw(w),
                                          residual=res[0] if res else None)
        return (hat, new) if res else hat

    if residual is None:
        return ax.map_workers(one, names, g)
    return ax.map_workers(one, names, g, residual)


def aggregate_by_strategy(
    g,
    ax: distributed.Collectives,
    axis_names: Sequence[str],
    strategy: str,
    method: str = "median",
    beta: float = 0.1,
    attack=None,
    agg_dtype=None,
    attack_key=None,
    nbins: int = 256,
    compression: str = "none",
    comp_key=None,
    comp_draw: Optional[Callable[[int], object]] = None,
):
    """Robustly aggregate the varying tree ``g`` over ``axis_names`` by
    strategy name; the result is replicated.

    ``strategy`` is any rounds.comm registry name except ``rs`` (which
    returns scattered shards); ``hierarchical`` needs exactly two worker
    axes (outer, inner).  ``compression`` runs each worker's contribution
    through the named codec before any collective (:func:`compress_workers`),
    so the strategies and their attacks see the decoded wire values.
    Error-feedback codecs are rejected here (this dispatch is stateless).
    """
    names = tuple(axis_names)
    if compression != "none":
        comp_lib.validate_compression_context(
            compression, stateful=False,
            where="the stateless aggregate_by_strategy dispatch")
        g = compress_workers(ax, names, g, compression, comp_key, comp_draw)
    if strategy == "gather":
        return distributed.robust_gather_agg(
            g, ax, names, method, beta, attack, agg_dtype, attack_key=attack_key)
    if strategy == "bucketed":
        return distributed.robust_bucketed_agg(
            g, ax, names, method, beta, attack, agg_dtype, attack_key=attack_key)
    if strategy == "chunked":
        return distributed.robust_chunked_agg(
            g, ax, names, method, beta, attack, agg_dtype, nbins=nbins,
            attack_key=attack_key)
    if strategy == "psum":
        return distributed.robust_psum_agg(
            g, ax, names, method, beta, attack, agg_dtype, attack_key=attack_key)
    if strategy == "hierarchical":
        if len(names) != 2:
            raise ValueError(
                f"hierarchical strategy needs two worker axes (outer, inner), got {names}")
        return distributed.robust_hierarchical_agg(
            g, ax, names[1], names[0], method, beta, attack, attack_key=attack_key)
    raise ValueError(
        f"unknown agg strategy {strategy!r}; round-level strategies: "
        "gather|bucketed|chunked|psum|hierarchical")


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
