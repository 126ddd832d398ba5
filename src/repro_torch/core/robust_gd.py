"""Algorithm 1 — Robust Distributed Gradient Descent (paper Section 4).

Single-device simulation of the m-worker protocol: per-worker gradients
come from ``torch.func.vmap(torch.func.grad(loss))`` over the worker
axis, Byzantine rows are replaced, every parameter leaf is aggregated
coordinate-wise (on the card: the hand-written median / trimmed-mean
kernels, one launch a step over all the leaves), and the projected GD
step runs.

The data layout is the paper's: ``m`` workers each hold ``n`` samples,
fixed once before training.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import rng
from repro_torch.core import aggregators
from repro_torch.core.attacks import AttackConfig, apply_gradient_attack
from repro_torch.device import resolve
from repro_torch.tree import tree_leaves, tree_map

_ATTACK_SEED = 0  # base seed of the per-round attack generators


@dataclasses.dataclass(frozen=True)
class RobustGDConfig:
    method: str = "median"  # any registered aggregator
    beta: float = 0.1  # trimmed-mean parameter (must be >= alpha)
    step_size: float = 0.1  # eta; the paper uses 1/L_F
    num_iters: int = 100  # T
    projection_radius: Optional[float] = None  # l2-ball radius (None = no projection)


def _project(w, radius: Optional[float]):
    if radius is None:
        return w
    norm = torch.linalg.vector_norm(torch.cat([t.reshape(-1) for t in tree_leaves(w)]))
    scale = (radius / norm.clamp(min=1e-12)).clamp(max=1.0)
    return tree_map(lambda t: t * scale, w)


def make_robust_gd_stages(
    loss_fn: Callable,
    worker_data,
    cfg: RobustGDConfig,
    attack: Optional[AttackConfig] = None,
    trajectory_fn: Optional[Callable] = None,
):
    """Algorithm 1 as a rounds.engine stage configuration.  Randomized
    attacks draw from a generator seeded with (``_ATTACK_SEED``, round) on
    the data's device."""
    from repro_torch.rounds import engine

    leaf = tree_leaves(worker_data)[0]
    m, device = leaf.shape[0], leaf.device
    per_worker_grads = torch.func.vmap(torch.func.grad(loss_fn), in_dims=(None, 0))
    aggregators.get_aggregator_spec(cfg.method)  # unknown names fail here
    mask = (attack.byzantine_mask(m, device=device) if attack is not None
            else torch.zeros(m, dtype=torch.bool, device=device))

    atk_fn = None
    if attack is not None and attack.alpha > 0:
        def atk_fn(grads, prev_g, i):
            gen = rng.generator(_ATTACK_SEED, i, device=device)
            return tree_map(
                lambda g, p: apply_gradient_attack(
                    attack, g, mask, generator=gen, prev_agg=p, rnd=i),
                grads, prev_g)

    def update(w, opt_state, g, i):
        w_new = tree_map(lambda p, d: p - cfg.step_size * d, w, g)
        return _project(w_new, cfg.projection_radius), opt_state

    return engine.RoundStages(
        local_work=lambda w, i: per_worker_grads(w, worker_data),
        aggregate=lambda grads: aggregators.tree_aggregate(grads, cfg.method, cfg.beta),
        update=update,
        attack=atk_fn,
        emit=((lambda w_new, g: trajectory_fn(w_new))
              if trajectory_fn is not None else None),
    )


def robust_gd(
    loss_fn: Callable,  # loss_fn(w, batch) -> scalar; batch leaves (n, ...)
    w0,
    worker_data,  # tree with leaves (m, n, ...): the worker-sharded dataset
    cfg: RobustGDConfig,
    attack: Optional[AttackConfig] = None,
    trajectory_fn: Optional[Callable] = None,
    *,
    ckpt_every: int = 0,
    ckpt_dir: Optional[str] = None,
    resume=False,
):
    """Run Algorithm 1 and return (w_T, per-iteration metrics).

    Computes on the device of ``w0`` / ``worker_data``.
    ``trajectory_fn(w) -> scalar`` is evaluated each iteration and stacked
    into the returned metrics.  With ``ckpt_every``/``ckpt_dir`` a
    RoundState snapshot is written every ``ckpt_every`` iterations;
    ``resume=True`` (or a round index) continues bit for bit.
    """
    from repro_torch.rounds import engine

    stages = make_robust_gd_stages(loss_fn, worker_data, cfg, attack, trajectory_fn)
    state, metrics = engine.run_scan(
        stages, engine.make_state(w0), cfg.num_iters,
        ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, resume=resume)
    return state["w"], metrics


def make_worker_shards(data, m: int):
    """Split a dataset tree with leaves (N, ...) into (m, N/m, ...)."""

    def split(leaf):
        n = leaf.shape[0] // m
        return leaf[: m * n].reshape((m, n) + tuple(leaf.shape[1:]))

    return tree_map(split, data)


# the paper's running example (Proposition 1 linear regression)


def linreg_loss(w: torch.Tensor, batch) -> torch.Tensor:
    x, y = batch
    return 0.5 * ((x @ w - y) ** 2).mean()


def run_linreg_experiment(
    seed: int,
    d: int,
    n: int,
    m: int,
    sigma: float,
    cfg: RobustGDConfig,
    attack: Optional[AttackConfig] = None,
    features: str = "rademacher",
    *,
    device="cuda",
):
    """Proposition 1 setting: y = x·w* + noise, x in {-1,1}^d (or
    Gaussian), noise ~ N(0, sigma^2).  Data are drawn on the CPU from
    ``seed`` and moved to ``device``.  Returns ``||w_T - w*||_2`` and the
    error trajectory."""
    from repro_torch.data.synthetic import linreg

    dev = resolve(device)
    data, w_star = linreg(torch.Generator().manual_seed(seed), n * m, d, sigma,
                          features, device=dev)
    shards = make_worker_shards((data["x"], data["y"]), m)
    w0 = torch.zeros(d, device=dev)
    traj = lambda w: torch.linalg.vector_norm(w - w_star)
    w_final, errs = robust_gd(linreg_loss, w0, shards, cfg, attack, traj)
    return torch.linalg.vector_norm(w_final - w_star), errs
