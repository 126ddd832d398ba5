"""Robust local-update GD: τ local steps per communication round.

The τ-interpolation between the paper's two algorithms (Zhou et al. 2021,
*Communication-efficient Byzantine-robust distributed learning with
statistical guarantee*):

- τ = 1 is Algorithm 1: every worker takes one local gradient step and the
  robust aggregate of those gradients drives the shared iterate.
  ``local_update_gd`` with ``tau=1`` is bit for bit
  ``core.robust_gd.robust_gd`` — the same vmap layout, the same per-round
  attack generators, the same aggregate carry;
- τ = ∞ is Algorithm 2: coordinate-wise aggregators are translation-
  equivariant and odd (agg(c − η·Δ) = c − η·agg(Δ)), so aggregating the
  accumulated local gradients Δ_i = Σ_k g_i(w_i^k) equals aggregating the
  local models, and one round with a large τ is the one-round estimator
  started from w₀.

Each round every worker runs τ full-batch GD steps from the shared iterate
on its own shard and transmits Δ_i; the server applies
w ← Π_W(w − η · agg(Δ₁ … Δ_m)), aggregating all leaves in one
``aggregators.tree_aggregate`` call (one B1/B2 launch a round on the card).
Byzantine workers corrupt the transmitted Δ rows, with per-round
generators (randomized attacks), the previous round's aggregate (adaptive
attacks) and, in :func:`run_local_update_rounds`, a per-round schedule
(``fed.rounds.AttackMixture``, the greedy adversary included).  One robust
aggregation a ROUND instead of a step: τ× fewer collective rounds for the
same local-step budget.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import rng
from repro_torch.attacks import engine
from repro_torch.core import aggregators
from repro_torch.core.robust_gd import _ATTACK_SEED, _project
from repro_torch.rounds import comm
from repro_torch.rounds import compression as comp_lib
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class LocalUpdateConfig:
    """Round and aggregation knobs of robust local-update GD.

    ``tau`` is the number of local GD steps between robust aggregations
    (τ = 1 is Algorithm 1); ``step_size`` is both the local learning rate
    and the server's scale on the aggregated delta, so one round at τ → ∞
    is the one-round estimator.
    """

    method: str = "median"  # any registered aggregator
    beta: float = 0.1
    step_size: float = 0.1  # η: local lr AND server scale on agg(Δ)
    tau: int = 1  # local steps per communication round
    num_rounds: int = 100  # R communication rounds
    projection_radius: Optional[float] = None  # Π_W: l2 ball (None = R^d)
    # rounds.compression scheme applied to each transmitted Δ row BEFORE
    # the attack and the aggregation; error-feedback residuals ride the
    # engine state
    compression: str = "none"


def _round_deltas(grads_shared, grads_local, w, worker_data, tau: int, eta):
    """The τ local steps of one round: the stacked accumulated local
    gradients Δᵢ = Σₖ gᵢ(wᵢᵏ), leaves (m, ...).

    The first gradient is taken at the SHARED iterate with robust_gd's
    vmap layout (in_dims=(None, 0)), which keeps τ = 1 bit-identical to
    Algorithm 1; the later steps carry per-worker iterates (in_dims=(0, 0)).
    """
    g0 = grads_shared(w, worker_data)
    if tau == 1:
        return g0
    ws = tree_map(lambda p, g: p.expand(g.shape) - eta * g, w, g0)
    acc = g0
    for _ in range(tau - 1):
        g = grads_local(ws, worker_data)
        ws = tree_map(lambda a, b: a - eta * b, ws, g)
        acc = tree_map(torch.add, acc, g)
    return acc


def _compress_deltas(deltas, res, name: str, r: int):
    """The transmitted Δ rows through the codec BEFORE the attack, so the
    attack and the aggregator see the decoded values.  Round r draws from a
    generator seeded with (``compression.DRAW_SEED``, r); ``res`` is the
    per-worker error-feedback residual tree (or ``()``)."""
    if name == "none":
        return deltas, res
    dev = tree_leaves(deltas)[0].device
    residual = None if (isinstance(res, tuple) and not res) else res
    gen = rng.generator(comp_lib.DRAW_SEED, r, device=dev)
    out, new_res = comp_lib.compress_tree_rows(name, deltas, generator=gen, residual=residual)
    return out, (() if new_res is None else new_res)


def _init_comp_state(name: str, w0, m: int):
    """The initial error-feedback residual of (m, ...)-stacked Δ trees,
    ``()`` for schemes without one."""
    if not comp_lib.get_compression(name).error_feedback:
        return ()
    return tree_map(lambda l: torch.zeros((m,) + tuple(l.shape), dtype=torch.float32,
                                          device=l.device), w0)


def _attack_deltas(deltas, prev_d, spec, alpha, strength, m: int, r: int):
    """Replace the Byzantine Δ rows.  Round r's randomized draws come from
    one generator seeded with (``_ATTACK_SEED``, r), shared by the leaves in
    order, as robust_gd draws; ``prev_d`` feeds adaptive attacks."""
    dev = tree_leaves(deltas)[0].device
    mask = engine.byzantine_mask(alpha, m, device=dev)
    gen = rng.generator(_ATTACK_SEED, r, device=dev)
    return tree_map(
        lambda dd, p: engine.apply_to_rows(
            spec, dd, mask, alpha=alpha, strength=strength, generator=gen,
            prev_agg=p, rnd=r),
        deltas, prev_d)


def make_local_update_stages(
    loss_fn: Callable,
    worker_data,
    cfg: LocalUpdateConfig,
    attack=None,  # AttackConfig | None (bare names / Attack specs raise)
    trajectory_fn: Optional[Callable] = None,
    emit: Optional[Callable] = None,
):
    """One τ-local-step communication round as a rounds.engine stage
    configuration (fixed attack): local Δ accumulation, codec, Byzantine
    row replacement, robust aggregation, server step.  ``emit`` overrides
    the per-round output (default: ``trajectory_fn(w_new)``)."""
    from repro_torch.rounds import engine as round_engine

    if cfg.tau < 1:
        raise ValueError(f"tau must be >= 1, got {cfg.tau}")
    m = tree_leaves(worker_data)[0].shape[0]
    grad_fn = torch.func.grad(loss_fn)
    grads_shared = torch.func.vmap(grad_fn, in_dims=(None, 0))
    grads_local = torch.func.vmap(grad_fn, in_dims=(0, 0))
    aggregators.get_aggregator_spec(cfg.method)  # unknown names fail here
    comp_lib.get_compression(cfg.compression)
    spec, alpha, strength = comm.resolve_attack_checked(attack)
    eta = cfg.step_size

    atk_fn = None
    if spec is not None and alpha > 0:
        def atk_fn(deltas, prev_d, r):
            return _attack_deltas(deltas, prev_d, spec, alpha, strength, m, r)

    def update(w, opt_state, d_agg, r):
        w_new = tree_map(lambda p, dd: p - eta * dd, w, d_agg)
        return _project(w_new, cfg.projection_radius), opt_state

    if emit is None and trajectory_fn is not None:
        emit = lambda w_new, d_agg: trajectory_fn(w_new)  # noqa: E731

    return round_engine.RoundStages(
        local_work=lambda w, r: _round_deltas(
            grads_shared, grads_local, w, worker_data, cfg.tau, eta),
        compress=lambda deltas, res, r: _compress_deltas(deltas, res, cfg.compression, r),
        attack=atk_fn,
        aggregate=lambda deltas: aggregators.tree_aggregate(deltas, cfg.method, cfg.beta),
        update=update,
        emit=emit,
    )


def local_update_gd(
    loss_fn: Callable,  # loss_fn(w, batch) -> scalar; batch leaves (n, ...)
    w0,
    worker_data,  # tree with leaves (m, n, ...): the worker-sharded dataset
    cfg: LocalUpdateConfig,
    attack=None,  # AttackConfig | None (bare names / Attack specs raise)
    trajectory_fn: Optional[Callable] = None,
    *,
    ckpt_every: int = 0,
    ckpt_dir: Optional[str] = None,
    resume=False,
):
    """Run robust local-update GD on the data's device; returns (w_R,
    per-round metrics).

    Mirrors ``robust_gd`` exactly at τ = 1.  ``trajectory_fn(w) -> scalar``
    is evaluated once per ROUND and stacked into the metrics.  The previous
    broadcast aggregate (adaptive attacks) and the per-worker
    error-feedback residual ride the engine's RoundState; with
    ``ckpt_every``/``ckpt_dir`` a snapshot is written every ``ckpt_every``
    rounds and ``resume=True`` (or a round index) continues bit for bit.
    """
    from repro_torch.rounds import engine as round_engine

    m = tree_leaves(worker_data)[0].shape[0]
    stages = make_local_update_stages(loss_fn, worker_data, cfg, attack, trajectory_fn)
    state = round_engine.make_state(
        w0, comp_res=_init_comp_state(cfg.compression, w0, m))
    state, metrics = round_engine.run_scan(
        stages, state, cfg.num_rounds,
        ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, resume=resume)
    return state["w"], metrics


def run_local_update_rounds(
    loss_fn: Callable,
    w0,
    worker_data,
    cfg: LocalUpdateConfig,
    mixture=None,  # fed.rounds.AttackMixture (None = clean)
    trajectory_fn: Optional[Callable] = None,
    *,
    ckpt_every: int = 0,
    ckpt_dir: Optional[str] = None,
    resume=False,
):
    """Round loop with a per-round attack SCHEDULE; returns (w, history).

    Each round the mixture picks the attack (``cycle``/``fixed``/
    ``greedy``), then one local-update round runs with the previous
    round's aggregate carried in.  ``history[r]`` is {"round", "attack",
    "tau", "delta_norm", "metric"} with ``metric = trajectory_fn(w_r)`` (0
    without one); the greedy scheduler's damage signal is the metric's
    drift (or the aggregate's norm without a trajectory_fn).  Runs on
    rounds.engine's scheduled driver, one round function per distinct
    attack, with the error-feedback residual carried across them on the
    engine state (it belongs to the workers, not to the attack).
    """
    from repro_torch.rounds import engine as round_engine

    m = tree_leaves(worker_data)[0].shape[0]

    def round_fn_for(attack):
        stages = make_local_update_stages(
            loss_fn, worker_data, cfg, attack, emit=lambda w_new, d_agg: d_agg)
        return round_engine.make_round_body(stages)

    def record(r, attack, state, d_agg):
        metric = (float(trajectory_fn(state["w"]))
                  if trajectory_fn is not None else 0.0)
        d_norm = float(torch.linalg.vector_norm(
            torch.cat([leaf.reshape(-1) for leaf in tree_leaves(d_agg)])))
        return {
            "round": r,
            "attack": attack.name if attack is not None else "none",
            "tau": cfg.tau,
            "delta_norm": d_norm,
            "metric": metric,
        }

    def damage(entry, prev):
        # the adversary's reward: the drift the broadcast state reveals
        return ((entry["metric"] - prev["metric"])
                if trajectory_fn is not None else entry["delta_norm"])

    init_metric = float(trajectory_fn(w0)) if trajectory_fn is not None else 0.0
    state = round_engine.make_state(
        w0, comp_res=_init_comp_state(cfg.compression, w0, m))
    state, history = round_engine.run_scheduled(
        round_fn_for, state, cfg.num_rounds, mixture=mixture, record=record,
        damage=damage, init_entry={"metric": init_metric},
        ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, resume=resume)
    return state["w"], history
