"""Algorithm 2 — the robust one-round algorithm (paper Section 5).

Each worker computes its local empirical risk minimizer; the master
outputs the coordinate-wise median (or β-trimmed mean) of the m local
solutions, in ONE communication round.  Theorem 7 gives the
Õ(α/√n + 1/√(nm) + 1/n) rate for strongly convex quadratic losses
(``core.theory.one_round_rate``); the paper's Table 4 runs it on the
logistic loss.  Two execution paths on one device:

- :func:`one_round`            vmap the local solver over the workers and
                               aggregate the stacked solutions with
                               ``aggregators.tree_aggregate`` (on the card:
                               one B1/B2 launch over all leaves for
                               m <= 64, the sort path above);
- :func:`one_round_streaming`  federated scale: worker solutions are
                               produced in chunks and folded into the
                               two-pass histogram sketch of
                               :mod:`repro_torch.fed.streaming` (B4/B5 on
                               the card), so the (m, d) solution matrix
                               never exists.

Byzantine model: a Byzantine machine may send an arbitrary model vector
instead of its local minimizer.  Gradient-space attacks of the
:mod:`repro_torch.attacks` registry apply with "model vector" for
"gradient"; data attacks (label_flip / random_label) corrupt the
Byzantine workers' samples upstream and need nothing here.

Local solvers: :func:`quadratic_local_solver` (the closed form
ŵ_i = −H_i⁻¹ p_i, paper Definition 9) and :func:`make_gd_local_solver`
(a fixed budget of full-batch GD steps).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import rng
from repro_torch.attacks import base as attack_base
from repro_torch.attacks import engine
from repro_torch.core import aggregators
from repro_torch.rounds import comm
from repro_torch.rounds import compression as comp_lib
from repro_torch.tree import ravel, tree_leaves, tree_map

_ATTACK_SEED = 0  # base seed of the attack generator when none is given


@dataclasses.dataclass(frozen=True)
class OneRoundConfig:
    """Aggregation and local-solver knobs of Algorithm 2."""

    method: str = "median"  # mean|median|trimmed_mean (streaming: approx_* too)
    beta: float = 0.1
    local_steps: int = 200  # for the gd solver
    local_lr: float = 0.5


def _refuse_adaptive(spec) -> None:
    if spec is not None and spec.adaptive:
        raise ValueError(
            f"attack {spec.name!r} is adaptive (reads the previous round's "
            "aggregate); the one-round algorithm has exactly one round, so "
            "there is nothing for it to read — use rounds.local_update")


def _attack_rows(stacked: torch.Tensor, attack, m: int,
                 generator: Optional[torch.Generator], rnd: int = 0) -> torch.Tensor:
    """Replace the Byzantine rows of a stacked (m, ...) solution tensor
    through the attack engine.  An attack without a Byzantine fraction
    (bare name / Attack spec) raises, and so does an adaptive attack: there
    is no previous round, so it would silently become the zero attack."""
    spec, alpha, strength = comm.resolve_attack_checked(attack)
    if spec is None or not alpha:
        return stacked
    _refuse_adaptive(spec)
    mask = engine.byzantine_mask(alpha, m, device=stacked.device)
    return engine.apply_to_rows(spec, stacked, mask, alpha=alpha, strength=strength,
                                generator=generator, rnd=rnd)


def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def one_round(
    local_solver: Callable,  # (worker_batch) -> w_hat (tree)
    worker_data,  # leaves (m, n, ...)
    cfg: OneRoundConfig = OneRoundConfig(),
    attack=None,  # AttackConfig | None (bare names / Attack specs raise)
    generator: Optional[torch.Generator] = None,
    compression: str = "none",
):
    """Run Algorithm 2 on the data's device: vmap the local solver over the
    workers, replace the Byzantine solutions, aggregate.

    ``generator`` feeds randomized attacks (default: a generator seeded
    with ``_ATTACK_SEED`` on the data's device).  ``compression`` runs
    each worker's transmitted solution through the named codec BEFORE the
    attack, so the attack observes and replaces decoded wire values;
    error-feedback schemes raise (with one round the residual would never
    be replayed).
    """
    m = tree_leaves(worker_data)[0].shape[0]
    dev = _device_of(worker_data)
    if compression != "none":
        comp_lib.validate_compression_context(
            compression, stateful=False, where="the one-round algorithm")
    w_hats = torch.func.vmap(local_solver)(worker_data)  # leaves (m, ...)
    if compression != "none":
        w_hats, _ = comp_lib.compress_tree_rows(
            compression, w_hats, generator=rng.generator(comp_lib.DRAW_SEED, device=dev))
    if generator is None:
        generator = rng.generator(_ATTACK_SEED, device=dev)
    w_hats = tree_map(lambda w: _attack_rows(w, attack, m, generator), w_hats)
    return aggregators.tree_aggregate(w_hats, cfg.method, cfg.beta)


def solution_chunks(local_solver: Callable, worker_data, attack=None, seed: int = 0,
                    chunk_workers: int = 256):
    """The worker solutions as a deterministic chunk stream, as
    :func:`one_round_streaming` feeds them to the sketch: returns
    ``(chunk_fn, num_chunks, d, unravel)``.  ``chunk_fn(j)`` is the j-th
    ``(rows, d)`` chunk of flattened solutions with the chunk's Byzantine
    rows (workers below the cut) replaced, from chunk-local honest
    statistics and, for a randomized attack, a generator seeded with
    (``seed``, j); ``unravel`` turns a (d,) vector back into a solution."""
    m = tree_leaves(worker_data)[0].shape[0]
    dev = _device_of(worker_data)
    spec, alpha, strength = comm.resolve_attack_checked(attack)
    _refuse_adaptive(spec)
    q = engine.num_byzantine(alpha, m) if spec is not None and alpha else 0
    bounds = [(s, min(s + chunk_workers, m)) for s in range(0, m, chunk_workers)]
    solve = torch.func.vmap(local_solver)

    def flat_rows(sol) -> torch.Tensor:
        return torch.cat([l.reshape(l.shape[0], -1) for l in tree_leaves(sol)], dim=1)

    def chunk_fn(j: int) -> torch.Tensor:
        s, e = bounds[j]
        rows = flat_rows(solve(tree_map(lambda l: l[s:e], worker_data)))
        if q and spec.access != attack_base.DATA:
            mask = torch.arange(s, e, device=dev) < q
            rows = engine.apply_to_rows(
                spec, rows, mask, alpha=alpha, strength=strength,
                generator=rng.generator(seed, j, device=dev))
        return rows

    probe = solve(tree_map(lambda l: l[:1], worker_data))  # one worker: the structure
    flat0, unravel = ravel(tree_map(lambda l: l[0], probe))
    return chunk_fn, len(bounds), flat0.shape[0], unravel


def one_round_streaming(
    local_solver: Callable,
    worker_data,  # leaves (m, n, ...)
    cfg: OneRoundConfig = OneRoundConfig(),
    attack=None,
    seed: int = 0,
    chunk_workers: int = 256,
    nbins: int = 256,
):
    """Algorithm 2 at federated scale through the streaming histogram
    sketch.

    Worker solutions are computed ``chunk_workers`` at a time (the only
    O(chunk) objects are one chunk of data and its (chunk, d) solutions)
    and folded into the two-pass sketch, so an m = 10^5 run costs
    O(chunk·d + nbins·d) memory beyond the data, and the result is within
    one bin width (max − min)/nbins of the exact coordinate-wise aggregate
    of the same rows.

    Attacks follow the federated rounds' convention
    (:func:`solution_chunks`): applied per chunk with the chunk's Byzantine
    mask and chunk-local honest statistics.  The sketch calls the chunk
    stream twice per chunk, so a randomized attack draws from a generator
    seeded with (``seed``, chunk), the same in both passes.
    """
    from repro_torch.fed import streaming

    chunk_fn, num_chunks, d, unravel = solution_chunks(
        local_solver, worker_data, attack, seed, chunk_workers)
    method = {"approx_median": "median",
              "approx_trimmed_mean": "trimmed_mean"}.get(cfg.method, cfg.method)
    out = streaming.streaming_aggregate(
        chunk_fn, num_chunks, d, method, cfg.beta, streaming.SketchConfig(nbins=nbins))
    return unravel(out)


def quadratic_local_solver(batch):
    """Exact local ERM for the quadratic loss ½‖y − Xw‖²/n:
    H_i = XᵀX/n (+ a 1e-6 ridge for a.s. strong convexity), p_i = −Xᵀy/n,
    ŵ_i = −H_i⁻¹ p_i (paper Definition 9)."""
    x, y = batch
    n = x.shape[0]
    h = x.T @ x / n + 1e-6 * torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    p = -(x.T @ y) / n
    return -torch.linalg.solve(h, p)


def make_gd_local_solver(loss_fn: Callable, w0, steps: int, lr: float):
    """Local full-batch GD for non-quadratic losses (e.g. logistic):
    ``solver(batch) -> ŵ`` runs ``steps`` GD steps at ``lr`` from the shared
    initial point ``w0`` — the τ → ∞ end of the local-update interpolation.
    Under ``vmap`` (as :func:`one_round` calls it) each step is one batched
    gradient over all workers."""
    grad_fn = torch.func.grad(loss_fn)

    def solver(batch):
        w = w0
        for _ in range(steps):
            g = grad_fn(w, batch)
            w = tree_map(lambda p, d: p - lr * d, w, g)
        return w

    return solver
