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

Payload compression (``RoundConfig.compression``, a
:mod:`repro_torch.rounds.compression` codec) runs on every client's payload
BEFORE the attack, so the colluders observe and replace decoded wire
values.  The codec's draws never depend on the chunking: int8's dither is
drawn per (round, client id) from :func:`repro_torch.rng.uniform`, the
count sketch's map once per round from a generator seeded with the round;
top-k's error-feedback residual is a (num_clients, d) state that
:func:`run_rounds` carries and :func:`update_comp_residual` updates.
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
from repro_torch.rounds import compression as comp_lib

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
    # rounds.compression codec on the transmitted client payloads, applied
    # BEFORE the attack; error-feedback schemes keep a (num_clients, d)
    # residual carried by run_rounds
    compression: str = "none"


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


def _raw_chunk_rows(pop: ClientPopulation, w: torch.Tensor, cids: torch.Tensor,
                    local_steps: int, local_lr: float) -> torch.Tensor:
    if local_steps > 1:
        return pop.client_deltas(w, cids, local_steps, local_lr)  # (rows, d)
    return pop.client_grads(w, cids)  # (rows, d)


def _compress_chunk(rows: torch.Tensor, cids: torch.Tensor, compression: str,
                    rnd: int, comp_res: Optional[torch.Tensor]):
    """One chunk of client payloads through the codec: returns the DECODED
    transmitted rows and the chunk's new residual rows (or None).

    The draws do not depend on the chunking: int8's dither is a function of
    (round, client id, element), the count sketch's map of the round alone;
    error-feedback rows are gathered per client id from the population
    residual ``comp_res``.
    """
    spec = comp_lib.get_compression(compression)
    if spec.name == "none":
        return rows, None
    if spec.randomized:
        nc, chunk = comp_lib.int8_draw_shape(rows.shape[1], spec.knob)
        u = rng.uniform(comp_lib.DRAW_SEED, rnd, cids, nc * chunk).reshape(-1, nc, chunk)
        return comp_lib.compress_rows(compression, rows, draw=u)
    if spec.error_feedback:
        return comp_lib.compress_rows(compression, rows, residual=comp_res[cids])
    gen = rng.generator(comp_lib.DRAW_SEED, rnd, device=rows.device) if spec.shared_key else None
    return comp_lib.compress_rows(compression, rows, generator=gen)


def _make_chunk_fn(pop: ClientPopulation, w: torch.Tensor, ids: torch.Tensor, bounds,
                   attack: Optional[AttackConfig],
                   prev_agg: Optional[torch.Tensor] = None, rnd: int = 0,
                   local_steps: int = 1, local_lr: float = 0.1,
                   compression: str = "none",
                   comp_res: Optional[torch.Tensor] = None):
    atk = attack.resolve()[0] if attack is not None and attack.alpha > 0 else None
    if comp_lib.get_compression(compression).error_feedback and comp_res is None:
        raise ValueError(
            f"compression {compression!r} carries per-client error-"
            "feedback residuals; aggregate through run_rounds (it owns "
            "the (num_clients, d) residual state)")

    def chunk_fn(j: int) -> torch.Tensor:
        s, e = bounds[j]
        cids = ids[s:e]
        g = _raw_chunk_rows(pop, w, cids, local_steps, local_lr)
        # codec first: honest and Byzantine clients share the wire, so the
        # attack sees decoded values (the residual is read-only here:
        # chunk_fn runs once per sketch pass; run_rounds updates it)
        g, _ = _compress_chunk(g, cids, compression, rnd, comp_res)
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
    comp_res: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One cohort's aggregated gradient (or accumulated local-update delta
    when ``rcfg.local_steps > 1``), streaming or exact per rcfg.method, on
    the population's device.  ``comp_res`` is the (num_clients, d)
    error-feedback residual when ``rcfg.compression`` carries one
    (run_rounds owns it; an error-feedback scheme without it raises)."""
    bounds = _chunk_bounds(ids.shape[0], rcfg.chunk_clients)
    chunk_fn = _make_chunk_fn(pop, w, ids, bounds, attack, prev_agg, rnd,
                              rcfg.local_steps, rcfg.local_lr,
                              rcfg.compression, comp_res)
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


def init_comp_residual(pop: ClientPopulation,
                       rcfg: RoundConfig) -> Optional[torch.Tensor]:
    """The population's error-feedback state: float32 zeros (num_clients,
    d) on the population's device for an error-feedback codec, else None.
    The residual belongs to each CLIENT and survives the rounds in which
    the client is not sampled."""
    if not comp_lib.get_compression(rcfg.compression).error_feedback:
        return None
    return torch.zeros((pop.cfg.num_clients, pop.cfg.dim), dtype=torch.float32,
                       device=pop.device)


def update_comp_residual(pop: ClientPopulation, w: torch.Tensor, ids: torch.Tensor,
                         rcfg: RoundConfig, comp_res: torch.Tensor, rnd: int) -> torch.Tensor:
    """Second pass of an error-feedback round: recompute the sampled
    clients' raw payloads and write their new residuals into a copy of the
    population state.  Kept out of chunk_fn, which the streaming sketch
    calls twice per chunk."""
    comp_res_new = comp_res.clone()
    for s, e in _chunk_bounds(ids.shape[0], rcfg.chunk_clients):
        cids = ids[s:e]
        rows = _raw_chunk_rows(pop, w, cids, rcfg.local_steps, rcfg.local_lr)
        _, new_res = _compress_chunk(rows, cids, rcfg.compression, rnd, comp_res)
        comp_res_new[cids] = new_res
    return comp_res_new


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
    aggregate, per-client error-feedback residual, optimizer state, base
    seed, round).  Round r's cohort is
    ``pop.sample_cohort(seed, r, ...)``.  ``ckpt_every``/``ckpt_dir``
    snapshot that state plus the history and the greedy scheduler's
    damage table; ``resume=True`` (or a round index) continues bit for
    bit — the same cohorts, the same adversary.
    """
    from repro_torch.rounds import engine as round_engine

    opt = get_optimizer(rcfg.optimizer, rcfg.lr)
    w = (torch.zeros(pop.cfg.dim, dtype=torch.float32, device=pop.device)
         if w0 is None else w0)
    comp_res0 = init_comp_residual(pop, rcfg)  # None, or the residual tensor
    stateless = comp_res0 is None  # the engine state holds () for no residual

    def round_fn_for(attack):
        def fn(state, r):
            w = state["w"]
            comp_res = None if stateless else state["comp_res"]
            # round 0 has no broadcast aggregate yet; any later round — a
            # resumed one included — reads it from the carried state
            prev_g = None if r == 0 else state["prev_agg"]
            ids = pop.sample_cohort(int(state["key"]), r, rcfg.cohort_size)
            g = aggregate_cohort(pop, w, ids, rcfg, attack, prev_agg=prev_g, rnd=r,
                                 comp_res=comp_res)
            if not stateless:
                comp_res = update_comp_residual(pop, w, ids, rcfg, comp_res, r)
            # adaptive attacks see the aggregate at TRANSMITTED-delta scale
            prev_g = g
            if rcfg.local_steps > 1:
                # the aggregated sum of local gradients, as a mean local
                # gradient, so lr semantics match local_steps=1
                g = g / torch.full_like(g, rcfg.local_steps)
            w_new, opt_state = opt.update(g, state["opt_state"], w,
                                          torch.tensor(r, dtype=torch.int64))
            new_state = dict(state, w=w_new, prev_agg=prev_g, opt_state=opt_state,
                             comp_res=() if stateless else comp_res,
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

    state = round_engine.make_state(
        w, comp_res=() if stateless else comp_res0, opt_state=opt.init(w),
        seed=rcfg.seed)
    state, history = round_engine.run_scheduled(
        round_fn_for, state, rcfg.num_rounds, mixture=mixture, record=record,
        damage=damage,
        init_entry={"err": float(torch.linalg.vector_norm(w - pop.w_star))},
        ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, resume=resume)
    return state["w"], history
