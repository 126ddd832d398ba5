"""Distributed round programs over a worker axis (the reference's
``repro.rounds.distributed``).

- :func:`aggregate_by_strategy` — the single name -> collective dispatcher
  for the :mod:`repro_torch.core.distributed` strategies (gather /
  bucketed / chunked / psum / hierarchical), with the stateless payload
  codecs run on each worker's contribution first.  ``launch/steps.py``
  and the round programs below call it; the worker axis is any
  :class:`~repro_torch.core.distributed.Collectives`.
- :func:`scan_local_sgd` — the local-SGD scan shared by the train step's
  τ > 1 rounds, :func:`make_local_update_round` and the federated
  ``client_deltas``.
- :func:`make_local_update_round` — local-update rounds as a distributed
  program: each worker runs τ local GD steps on its own shard with no
  collective, and the accumulated local gradients meet in ONE
  aggregation a round, whatever τ.
- :func:`one_round_distributed` — Algorithm 2 as a distributed program:
  each worker solves on its own shard, and the m local minimizers meet in
  one aggregation (``strategy='chunked'``: the histogram sketch, whose
  collective bytes do not grow with m).

Both programs run over a ``launch.mesh.Mesh``, so over either
``Collectives``: on the in-process debug mesh the worker data's leaves are
``(m, n, ...)`` (``core.robust_gd.make_worker_shards``' layout) and the
workers run one after the other; under a process group
(``make_production_mesh``, ``vshape`` ``()``) each rank passes its own
``(n, ...)`` shard.  Their build-time refusals are the reference's: an
attack the strategy cannot reproduce (``comm.validate_attack_strategy``),
an adaptive attack, an error-feedback codec.  Single-device local-update
rounds live in :mod:`repro_torch.rounds.local_update`.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch import rng, trace
from repro_torch.core import distributed
from repro_torch.rounds import comm
from repro_torch.rounds import compression as comp_lib
from repro_torch.rounds.one_round import OneRoundConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

#: the codecs' key base when the caller gives none (the reference's PRNGKey(13))
_COMP_KEY = 13
#: the round programs' key bases: attacks fold the round into _ATTACK_KEY,
#: codecs into _ROUND_COMP_KEY (the reference's PRNGKey(0) and PRNGKey(11))
_ATTACK_KEY, _ROUND_COMP_KEY = 0, 11


def compress_workers(ax: distributed.Collectives, axis_names: Sequence[str], g, name: str,
                     comp_key=None, draw: Optional[Callable[[int], object]] = None,
                     residual=None, model_dims=None, out=None):
    """Each worker's tree ``g`` through the codec ``name`` as ONE flat
    message (``compression.compress_tree``).  A randomized codec draws from
    the generator of (``comp_key``, worker), a shared-key codec from that
    of ``comp_key`` alone (one map for every worker); ``draw(worker)``
    injects a worker's draw instead.  With ``residual`` (varying (D,)
    error-feedback rows) returns ``(g_hat, new_residual)``, else ``g_hat``,
    written into ``out`` when given (``g``'s layout, with ``residual`` a
    pair of trees; the inputs themselves may be given, as a worker's
    result is computed before it is written).

    Under a model axis the message is still the worker's whole raveled
    gradient: where this process holds a model rank's shards
    (``ax.holds_shards``, a process group), its split leaves
    (``model_dims``, each leaf's split dim, -1 whole) are gathered over
    the model axis into the whole tree, which is compressed (the same
    generator on every model rank of a worker, and the error-feedback
    residual a whole (D,) row on each of them), and the rank's chunks are
    cut back out; in process the tree is the global view already."""
    names = tuple(axis_names)
    spec = comp_lib.get_compression(name)
    base = _COMP_KEY if comp_key is None else comp_key
    dev = tree_leaves(g)[0].device
    dims = list(model_dims) if model_dims is not None and ax.holds_shards else None

    def one(w, tree, *res):
        gen = None
        if draw is None and spec.randomized:
            gen = rng.generator(base, w, device=dev)
        elif draw is None and spec.shared_key:
            gen = rng.generator(base, device=dev)
        if dims is not None:
            tree = tree_unflatten_like(tree, [t if d < 0 else ax.model_full(t, d)
                                              for t, d in zip(tree_leaves(tree), dims)])
        hat, new = comp_lib.compress_tree(name, tree, generator=gen,
                                          draw=None if draw is None else draw(w),
                                          residual=res[0] if res else None)
        if dims is not None:
            hat = tree_unflatten_like(hat, [t if d < 0 else ax.model_cut(t, d)
                                            for t, d in zip(tree_leaves(hat), dims)])
        return (hat, new) if res else hat

    if residual is None:
        return ax.map_workers(one, names, g, out=out)
    return ax.map_workers(one, names, g, residual, out=out)


@trace.spanned("aggregate")
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
    model_dims=None,
):
    """Robustly aggregate the varying tree ``g`` over ``axis_names`` by
    strategy name; the result is replicated.

    Under a model axis ``g`` is a model rank's leaves (in process the
    global view, the same bits: the estimators are coordinate-wise) and
    ``model_dims`` each leaf's split dim (:func:`tree_leaves` order, -1
    whole), with which the gather strategies complete a leaf-global
    attack's sums over the model shards, a randomized attack draws its
    payload over each whole leaf (the chunked and psum strategies too),
    and a codec compresses each worker's whole gradient
    (:func:`compress_workers`).  The bucketed strategies refuse a
    leaf-global attack there: their buckets would be slices of a rank's
    own ravel, not of the global one the reference's GSPMD cuts; a
    randomized attack's buckets are drawn whole, so a rank holding shards
    gathers its tree over the model axis, runs the strategy on the whole
    tree (model 1's function) and keeps its chunks.

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
        g = compress_workers(ax, names, g, compression, comp_key, comp_draw,
                             model_dims=model_dims)
    if strategy == "gather":
        return distributed.robust_gather_agg(
            g, ax, names, method, beta, attack, agg_dtype, attack_key=attack_key,
            model_dims=model_dims)
    if strategy == "bucketed":
        comm.refuse_leaf_global(attack, strategy, ax.model)
        atk = comm.resolve_attack(attack)[0]
        if atk is not None and atk.randomized and ax.holds_shards and model_dims is not None:
            dims = list(model_dims)
            whole = tree_unflatten_like(g, [t if d < 0 else ax.model_full(t, d)
                                            for t, d in zip(tree_leaves(g), dims)])
            agg = distributed.robust_bucketed_agg(
                whole, ax, names, method, beta, attack, agg_dtype, attack_key=attack_key)
            return tree_unflatten_like(g, [t if d < 0 else ax.model_cut(t, d)
                                           for t, d in zip(tree_leaves(agg), dims)])
        return distributed.robust_bucketed_agg(
            g, ax, names, method, beta, attack, agg_dtype, attack_key=attack_key)
    if strategy == "chunked":
        return distributed.robust_chunked_agg(
            g, ax, names, method, beta, attack, agg_dtype, nbins=nbins,
            attack_key=attack_key, model_dims=model_dims)
    if strategy == "psum":
        return distributed.robust_psum_agg(
            g, ax, names, method, beta, attack, agg_dtype, attack_key=attack_key,
            model_dims=model_dims)
    if strategy == "hierarchical":
        if len(names) != 2:
            raise ValueError(
                f"hierarchical strategy needs two worker axes (outer, inner), got {names}")
        return distributed.robust_hierarchical_agg(
            g, ax, names[1], names[0], method, beta, attack, attack_key=attack_key,
            model_dims=model_dims)
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


def _refuse(attack, strategy: str, compression: str, where: str, adaptive: str) -> None:
    """The round programs' build-time refusals, as the reference's."""
    comm.validate_attack_strategy(attack, strategy)
    comp_lib.validate_compression_context(compression, stateful=False, where=where)
    spec = comm.resolve_attack(attack)[0]
    if spec is not None and spec.adaptive:
        raise ValueError(f"attack {spec.name!r} is adaptive{adaptive}")


def _worker_shards(ax: distributed.Collectives, names, worker_data):
    """The worker data as values varying over ``names``: (m, n, ...) leaves
    reshaped to the in-process ``vshape``; a rank's own (n, ...) shard as
    it is under a process group."""
    if ax.outer(names):
        raise ValueError(f"the round programs need every worker axis in axis_names, "
                         f"got {names}")
    vs, m = ax.vshape(names), ax.size(names)
    if not vs:
        return worker_data

    def one(t):
        if t.shape[0] != m:
            raise ValueError(f"worker data of leading dim {t.shape[0]}, want the {m} workers")
        return t.reshape(vs + t.shape[1:])

    return tree_map(one, worker_data)


def make_local_update_round(
    loss_fn: Callable,
    cfg,  # rounds.local_update.LocalUpdateConfig
    mesh,
    strategy: str = "gather",
    attack=None,
    axis_names: Sequence[str] = ("data",),
    agg_dtype=None,
    compression: str = "none",
):
    """Build the distributed local-update round step.

    Returns ``round_step(w, worker_data, r) -> w_new``: each worker runs
    ``cfg.tau`` local GD steps at ``cfg.step_size`` on its own shard
    (:func:`scan_local_sgd`; no collective inside the τ loop), the
    accumulated local gradients meet in exactly ONE
    :func:`aggregate_by_strategy` call, and every worker applies
    w - η · agg.  The round ``r`` folds into the attack key
    (``rng.fold(0, r)``) and the codec key (``rng.fold(11, r)``), so
    randomized attacks and codecs draw afresh each round.  ``loss_fn(w,
    batch) -> scalar``, ``w`` a tensor or a tree of them.

    Refused at build time, as in the reference: an attack the strategy
    cannot reproduce, an adaptive attack (no previous aggregate is
    threaded; use ``rounds.local_update.local_update_gd``) and an
    error-feedback codec (the step carries no residual)."""
    _refuse(attack, strategy, compression, "the distributed round step",
            " (reads the previous aggregate), which the distributed round step does not "
            "thread; use rounds.local_update.local_update_gd")
    names = tuple(axis_names)
    ax = mesh.axes
    eta = cfg.step_size
    grad_and_value = torch.func.grad_and_value(loss_fn)

    def local(w, batch):
        delta, _ = scan_local_sgd(lambda p: grad_and_value(p, batch)[::-1], w, cfg.tau, eta)
        return delta

    def round_step(w, worker_data, r):
        r = int(r)
        data = _worker_shards(ax, names, worker_data)
        deltas = ax.map_workers(lambda _, batch: local(w, batch), names, data)
        d_agg = aggregate_by_strategy(
            deltas, ax, names, strategy, cfg.method, cfg.beta, attack, agg_dtype,
            attack_key=rng.fold(_ATTACK_KEY, r), compression=compression,
            comp_key=rng.fold(_ROUND_COMP_KEY, r))
        return tree_map(lambda p, dd: p - eta * dd, w, d_agg)

    return round_step


def one_round_distributed(
    local_solver: Callable,
    worker_data,
    mesh,
    cfg: OneRoundConfig = OneRoundConfig(),
    strategy: str = "gather",
    attack=None,
    attack_key=None,
    axis_names: Sequence[str] = ("data",),
    compression: str = "none",
):
    """Algorithm 2 over the mesh's workers: each solves on its own shard
    (``local_solver(batch) -> w_hat``, through ``map_workers``: no
    collective), the m local minimizers meet in ONE
    :func:`aggregate_by_strategy` call, and the replicated aggregate tree
    is returned.  ``attack_key`` seeds randomized attacks; codecs draw
    from the key 11 (the reference's PRNGKey(11)).  Refused at build time,
    as in the reference: an attack the strategy cannot reproduce (an
    omniscient one on ``chunked``), an adaptive attack, an error-feedback
    codec (with one round its residual would never be replayed)."""
    _refuse(attack, strategy, compression, "the one-round program",
            "; the one-round algorithm has no previous round to read — use "
            "rounds.local_update")
    names = tuple(axis_names)
    ax = mesh.axes
    data = _worker_shards(ax, names, worker_data)
    w_hats = ax.map_workers(lambda _, batch: local_solver(batch), names, data)
    return aggregate_by_strategy(w_hats, ax, names, strategy, cfg.method, cfg.beta, attack,
                                 attack_key=attack_key, compression=compression,
                                 comp_key=_ROUND_COMP_KEY)
