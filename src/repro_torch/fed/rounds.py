"""Federated round scheduler: cohort sampling → chunked robust aggregation
→ optimizer update.

Each round the server samples a cohort from the client population,
streams the cohort's payloads in fixed-size chunks through an aggregator
and applies one optimizer step (:mod:`repro_torch.optim`).  The
per-client payload is the local full-batch gradient (``local_steps=1``,
FedSGD) or the accumulated gradient of ``local_steps`` local SGD steps at
``local_lr`` (:meth:`~repro_torch.fed.population.ClientPopulation.client_deltas`),
aggregated once per round and rescaled by 1/τ so the optimizer's lr
semantics do not depend on τ.  Two aggregation paths:

- **streaming** (``method`` in STREAMING_METHODS): the two-pass histogram
  sketch of :mod:`repro_torch.fed.streaming`, through the min/max and
  histogram kernels on the card; the ``(cohort, d)`` matrix never exists,
  only the id vector is O(cohort);
- **exact** (any :mod:`repro_torch.core.aggregators` name, e.g.
  ``median``): gathers the cohort chunk by chunk into ``(cohort, d)`` and
  applies the exact aggregator — the small-cohort reference.

Byzantine behaviour plugs in through :class:`AttackConfig`: gradient
attacks are applied per chunk with the chunk's Byzantine mask (from the
client ids), using chunk-local honest statistics.  Adaptive attacks see
the previous round's broadcast aggregate; randomized ones draw from a
generator seeded with (round, chunk).  Attack mixtures vary the attack
across rounds: ``cycle``/``fixed``, or ``greedy`` (the adaptive adversary
of :class:`~repro_torch.attacks.schedule.GreedyScheduler`).

Payload compression is not ported yet: payloads go on the wire as they
are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.attacks.schedule import GreedyScheduler
from repro_torch.core import aggregators
from repro_torch.core.attacks import AttackConfig, apply_gradient_attack
from repro_torch.fed import streaming
from repro_torch.fed.population import ClientPopulation
from repro_torch.optim.optimizers import get_optimizer

STREAMING_METHODS = ("approx_median", "approx_trimmed_mean", "stream_mean")

_ATTACK_SEED = 7  # base seed of the per-(round, chunk) attack generators


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    num_rounds: int = 20
    cohort_size: int = 1024
    chunk_clients: int = 256  # streaming chunk (rows held at once)
    method: str = "approx_median"  # STREAMING_METHODS or an exact aggregator name
    beta: float = 0.1
    nbins: int = 256
    optimizer: str = "sgd"
    lr: float = 0.2
    seed: int = 0
    # local-update cohort rounds: each sampled client runs local_steps
    # local SGD steps at local_lr and transmits its accumulated local
    # gradient; 1 = plain FedSGD rounds
    local_steps: int = 1
    local_lr: float = 0.1


@dataclasses.dataclass(frozen=True)
class AttackMixture:
    """Per-round attack schedule.

    ``cycle``: round r uses attacks[r % len(attacks)].  ``fixed``: always
    attacks[0].  ``greedy``: the adaptive adversary — explore each attack,
    then replay the one that did most damage (state held by the
    :class:`GreedyScheduler` from :meth:`make_scheduler`).  An empty tuple
    means no attack.
    """

    attacks: tuple = ()
    schedule: str = "cycle"  # cycle|fixed|greedy

    def make_scheduler(self) -> Optional[GreedyScheduler]:
        if self.schedule == "greedy" and self.attacks:
            return GreedyScheduler(len(self.attacks))
        return None

    def for_round(self, r: int,
                  scheduler: Optional[GreedyScheduler] = None) -> Optional[AttackConfig]:
        if not self.attacks:
            return None
        if self.schedule == "fixed":
            return self.attacks[0]
        if self.schedule == "cycle":
            return self.attacks[r % len(self.attacks)]
        if self.schedule == "greedy":
            if scheduler is None:
                raise ValueError("greedy schedule needs the scheduler from "
                                 "make_scheduler() (run_rounds manages one)")
            return self.attacks[scheduler.pick(r)]
        raise ValueError(f"unknown schedule {self.schedule!r}")


def _chunk_bounds(total: int, chunk: int) -> list:
    return [(s, min(s + chunk, total)) for s in range(0, total, chunk)]


def _make_chunk_fn(pop: ClientPopulation, w: torch.Tensor, ids: torch.Tensor, bounds,
                   attack: Optional[AttackConfig],
                   prev_agg: Optional[torch.Tensor] = None, rnd: int = 0,
                   local_steps: int = 1, local_lr: float = 0.1):
    atk = attack.resolve()[0] if attack is not None and attack.alpha > 0 else None

    def chunk_fn(j: int) -> torch.Tensor:
        s, e = bounds[j]
        cids = ids[s:e]
        if local_steps > 1:
            g = pop.client_deltas(w, cids, local_steps, local_lr)
        else:
            g = pop.client_grads(w, cids)
        if atk is not None:
            gen = (rng.generator(_ATTACK_SEED, rnd, j, device=g.device)
                   if atk.randomized else None)
            g = apply_gradient_attack(attack, g, pop.is_byzantine(cids),
                                      generator=gen, prev_agg=prev_agg, rnd=rnd)
        return g

    return chunk_fn


def aggregate_cohort(
    pop: ClientPopulation,
    w: torch.Tensor,
    ids: torch.Tensor,
    rcfg: RoundConfig,
    attack: Optional[AttackConfig] = None,
    prev_agg: Optional[torch.Tensor] = None,
    rnd: int = 0,
) -> torch.Tensor:
    """One cohort's aggregated gradient (or accumulated local-update delta
    when ``rcfg.local_steps > 1``), streaming or exact per rcfg.method, on
    the population's device."""
    bounds = _chunk_bounds(ids.shape[0], rcfg.chunk_clients)
    chunk_fn = _make_chunk_fn(pop, w, ids, bounds, attack, prev_agg, rnd,
                              rcfg.local_steps, rcfg.local_lr)
    if rcfg.method in STREAMING_METHODS:
        method = {"approx_median": "median",
                  "approx_trimmed_mean": "trimmed_mean",
                  "stream_mean": "mean"}[rcfg.method]
        scfg = streaming.SketchConfig(nbins=rcfg.nbins)
        return streaming.streaming_aggregate(
            chunk_fn, len(bounds), pop.cfg.dim, method, rcfg.beta, scfg)
    # exact reference path: materialize (cohort, d) — small cohorts only
    stacked = torch.cat([chunk_fn(j) for j in range(len(bounds))], dim=0)
    return aggregators.get_aggregator(rcfg.method, rcfg.beta)(stacked)


def run_rounds(
    pop: ClientPopulation,
    rcfg: RoundConfig,
    mixture: AttackMixture = AttackMixture(),
    w0: Optional[torch.Tensor] = None,
    *,
    ckpt_every: int = 0,
    ckpt_dir: Optional[str] = None,
    resume=False,
):
    """Run the server loop on the population's device; returns (w_final,
    history).

    history[r] = {"round", "attack", "grad_norm", "err"} with
    ``err = ‖w_r − w*‖₂`` against the population optimum.

    Runs on :func:`repro_torch.rounds.engine.run_scheduled` with an eager
    round body over the engine's RoundState (iterate, previous broadcast
    aggregate, optimizer state, base seed, round).  Round r's cohort is
    ``pop.sample_cohort(seed, r, ...)``.  ``ckpt_every``/``ckpt_dir``
    snapshot that state plus the history and the greedy scheduler's
    damage table; ``resume=True`` (or a round index) continues bit for
    bit — the same cohorts, the same adversary.
    """
    from repro_torch.rounds import engine as round_engine

    opt = get_optimizer(rcfg.optimizer, rcfg.lr)
    w = (torch.zeros(pop.cfg.dim, dtype=torch.float32, device=pop.device)
         if w0 is None else w0)

    def round_fn_for(attack):
        def fn(state, r):
            w = state["w"]
            # round 0 has no broadcast aggregate yet; any later round — a
            # resumed one included — reads it from the carried state
            prev_g = None if r == 0 else state["prev_agg"]
            ids = pop.sample_cohort(int(state["key"]), r, rcfg.cohort_size)
            g = aggregate_cohort(pop, w, ids, rcfg, attack, prev_agg=prev_g, rnd=r)
            # adaptive attacks see the aggregate at TRANSMITTED-delta scale
            prev_g = g
            if rcfg.local_steps > 1:
                # the aggregated sum of local gradients, as a mean local
                # gradient, so lr semantics match local_steps=1
                g = g / torch.full_like(g, rcfg.local_steps)
            w_new, opt_state = opt.update(g, state["opt_state"], w,
                                          torch.tensor(r, dtype=torch.int64))
            new_state = dict(state, w=w_new, prev_agg=prev_g, opt_state=opt_state,
                             round=torch.tensor(r + 1, dtype=torch.int64))
            return new_state, {"g": g}

        return fn

    def record(r, attack, state, extras):
        return {
            "round": r,
            "attack": attack.name if attack is not None else "none",
            "grad_norm": float(torch.linalg.vector_norm(extras["g"])),
            "err": float(torch.linalg.vector_norm(state["w"] - pop.w_star)),
        }

    def damage(entry, prev):
        # the adversary's reward: how far this round moved the model AWAY
        # from the optimum (observable drift)
        return entry["err"] - prev["err"]

    state = round_engine.make_state(w, opt_state=opt.init(w), seed=rcfg.seed)
    state, history = round_engine.run_scheduled(
        round_fn_for, state, rcfg.num_rounds, mixture=mixture, record=record,
        damage=damage,
        init_entry={"err": float(torch.linalg.vector_norm(w - pop.w_star))},
        ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, resume=resume)
    return state["w"], history
