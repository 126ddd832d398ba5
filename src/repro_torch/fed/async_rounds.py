"""Buffered asynchronous federated rounds (FedBuffer-style).

The synchronous scheduler (:mod:`repro_torch.fed.rounds`) closes a round
only when every sampled client reports — one straggler stalls the cohort
and a dropout deadlocks it.  This engine closes each round when the first
``k`` of the cohort's reports arrive:

1. sample the round's cohort exactly as ``run_rounds`` does (the same
   seed and round, so enabling the simulator never changes WHO is
   sampled);
2. draw per-client arrival times on the CPU
   (:meth:`ClientPopulation.arrival_times`: latency model, persistent
   stragglers, honest dropout) and merge them with the *pending queue* of
   clients still in flight from earlier rounds;
3. buffer the first ``k`` arrivals (stable order: time, then adversarial
   priority, then insertion) and close at the k-th arrival time — or at
   ``timeout`` when dropout leaves the buffer under-full;
4. compute each buffered client's payload against the iterate it was
   ACTUALLY sent (a report born in round ``r-s`` used ``w_{r-s}``), run
   the staleness policy (:mod:`repro_torch.fed.staleness`: damp / widen
   trim / drop), then the unchanged robust aggregator, then one optimizer
   step.  Late finite arrivals stay pending with their remaining time;
   reports older than ``max_staleness`` are discarded.

Timing is part of the threat model: an attack registered with an
``arrival`` behaviour controls WHEN its Byzantine clients report —
``first`` rushes the buffer window, ``last`` lags onto the buffer tail
(maximally stale yet still aggregated: ``stale_exploit``), ``greedy``
explores the modes per round and replays the most damaging
(:class:`~repro_torch.attacks.schedule.ArrivalScheduler`, fed the same
err-drift signal as the greedy attack scheduler).  Adaptive attacks see
the broadcast-aggregate history at their true staleness depth.

The host scheduling state is numpy: the buffer sort is ``np.lexsort`` in
float64, the pending queue three arrays (ids, born round, remaining
time), and each staleness group is selected with a boolean mask and moved
to the device as one id tensor.  The device computes each buffered
client's rows once and aggregates the materialized buffer (the min/max
and histogram kernels for the streaming methods, B1/B2 for the exact
ones).

Synchronous pin: with ``buffer_k == cohort_size`` and zero latency the
buffer is the whole fresh cohort in cohort order and every staleness
policy is the identity, so the engine calls
``fed.rounds.aggregate_cohort`` itself — bit for bit ``run_rounds``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.attacks.schedule import ArrivalScheduler
from repro_torch.core import aggregators
from repro_torch.core.attacks import AttackConfig, apply_gradient_attack
from repro_torch.fed import rounds as sync_rounds
from repro_torch.fed import staleness as staleness_policies
from repro_torch.fed import streaming
from repro_torch.fed.population import ArrivalConfig, ClientPopulation
from repro_torch.fed.rounds import STREAMING_METHODS, AttackMixture, RoundConfig
from repro_torch.optim.optimizers import get_optimizer


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Buffered-round knobs.

    ``buffer_k`` is the number of arrivals that closes a round (clipped
    to the candidate count).  ``max_staleness`` is the oldest report (in
    rounds) the server still accepts — it also bounds the iterate and
    aggregate history the engine keeps.  ``policy`` names a registered
    staleness policy; ``policy_knob``/``policy_cap`` override its defaults
    when set.  ``timeout`` closes an under-full buffer at that simulated
    time (None = wait for the k-th finite arrival)."""

    buffer_k: int = 64
    max_staleness: int = 4
    policy: str = "damped"
    policy_knob: Optional[float] = None
    policy_cap: Optional[int] = None
    timeout: Optional[float] = None

    def __post_init__(self):
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")
        if self.max_staleness < 1:
            raise ValueError(
                f"max_staleness must be >= 1, got {self.max_staleness}")
        staleness_policies.get_policy(self.policy)  # validate early


def _resolve_arrival(attack: Optional[AttackConfig]) -> Optional[str]:
    """The engine-attack arrival behaviour for this round's attack."""
    if attack is None or attack.alpha <= 0:
        return None
    atk, _ = attack.resolve()
    return None if atk is None else atk.arrival


def _group_rows(pop: ClientPopulation, w_used: torch.Tensor, cids: torch.Tensor,
                rcfg: RoundConfig, attack: Optional[AttackConfig],
                agg_hist: torch.Tensor, s: int, born: int) -> torch.Tensor:
    """Payload rows of one staleness group, chunked like the sync engine.

    ``w_used`` is the iterate the group's clients were broadcast (s rounds
    old); a randomized attack draws from a generator seeded with
    (_ATTACK_SEED, born round, chunk), so a replayed report carries the
    randomness it was computed with.  The attack sees the aggregate the
    group last saw as ``prev_agg`` (``agg_hist[s]``) and the whole history
    at staleness ``s + 1``.
    """
    atk = attack.resolve()[0] if attack is not None and attack.alpha > 0 else None
    out = []
    for j, (a, b) in enumerate(sync_rounds._chunk_bounds(cids.shape[0], rcfg.chunk_clients)):
        c = cids[a:b]
        g = sync_rounds._raw_chunk_rows(pop, w_used, c, rcfg.local_steps, rcfg.local_lr)
        if atk is not None:
            gen = (rng.generator(sync_rounds._ATTACK_SEED, born, j, device=g.device)
                   if atk.randomized else None)
            g = apply_gradient_attack(attack, g, pop.is_byzantine(c), generator=gen,
                                      prev_agg=agg_hist[s], agg_history=agg_hist,
                                      staleness=s + 1, rnd=born)
        out.append(g)
    return torch.cat(out, dim=0)


def _aggregate_buffer(rows: torch.Tensor, rcfg: RoundConfig,
                      beta_eff: float) -> torch.Tensor:
    """The sync engine's two aggregation paths over a materialized buffer."""
    if rcfg.method in STREAMING_METHODS:
        method = {"approx_median": "median",
                  "approx_trimmed_mean": "trimmed_mean",
                  "stream_mean": "mean"}[rcfg.method]
        scfg = streaming.SketchConfig(nbins=rcfg.nbins)
        return streaming.aggregate_array_chunked(
            rows, method, beta_eff, rcfg.chunk_clients, scfg)
    return aggregators.get_aggregator(rcfg.method, beta_eff)(rows)


def _time_byzantine(t: np.ndarray, prio: np.ndarray, byz_new: np.ndarray,
                    mode: str, k: int, timeout: Optional[float]) -> None:
    """Apply an arrival-timing override to this round's NEW Byzantine
    arrivals, in place.

    ``first``: report at t=0 ahead of every honest tie.  ``last``: lag
    onto the buffer tail — land exactly at the (k-q)-th non-Byzantine
    finite arrival (the latest moment that still makes the buffer), with
    tie-priority AFTER honest rows, clamped to ``timeout``."""
    q = int(byz_new.sum())
    if q == 0 or mode == "honest":
        return
    if mode == "first":
        t[byz_new] = 0.0
        prio[byz_new] = -1
        return
    # mode == "last"
    others = np.sort(t[~byz_new & np.isfinite(t)])
    want = k - q  # honest arrivals that precede the Byzantine tail
    if want <= 0:
        boundary = 0.0
    elif len(others) >= want:
        boundary = float(others[want - 1])
    else:
        boundary = float(others[-1]) if len(others) else 0.0
    if timeout is not None:
        boundary = min(boundary, timeout)
    t[byz_new] = boundary
    prio[byz_new] = 1


def run_async_rounds(
    pop: ClientPopulation,
    rcfg: RoundConfig,
    async_cfg: AsyncConfig,
    arrival: ArrivalConfig = ArrivalConfig(),
    mixture: AttackMixture = AttackMixture(),
    w0: Optional[torch.Tensor] = None,
    *,
    ckpt_every: int = 0,
    ckpt_dir: Optional[str] = None,
    resume=False,
):
    """Run the buffered async server loop on the population's device;
    returns (w_final, history).

    ``history[r]`` carries the synchronous keys ({"round", "attack",
    "grad_norm", "err"}, as ``run_rounds``) plus ``duration`` (simulated
    round length = k-th arrival time), ``buffer`` (rows aggregated after
    policy drops), ``staleness_mean`` (mean staleness of the buffer),
    ``pending`` (in-flight reports carried to the next round) and
    ``timing`` (the Byzantine arrival mode in effect).

    ``ckpt_every``/``ckpt_dir``/``resume`` snapshot and restore the whole
    async state through :mod:`repro_torch.rounds.engine`: the iterate, the
    optimizer state and the aggregate and iterate histories on the device
    side; the pending queue, the history, the previous err and both greedy
    schedulers on the host side — a killed run resumes bit for bit.
    """
    from repro_torch.rounds import engine as round_engine

    if rcfg.compression != "none":
        # the staleness regrouping recomputes rows per depth and does not
        # thread codec state
        raise ValueError(
            "the async round engine does not thread compression; use the "
            "synchronous run_rounds for compressed payloads")
    H = async_cfg.max_staleness + 1
    dim, dev = pop.cfg.dim, pop.device
    opt = get_optimizer(rcfg.optimizer, rcfg.lr)
    w = torch.zeros(dim, dtype=torch.float32, device=dev) if w0 is None else w0
    state = opt.init(w)
    scheduler = mixture.make_scheduler()
    timing_sched: Optional[ArrivalScheduler] = None
    history = []
    prev_g = None  # previous broadcast aggregate, transmitted scale (sync pin)
    agg_hist = torch.zeros((H, dim), dtype=torch.float32, device=dev)  # newest first
    w_hist = [w] * H  # w_hist[s] == iterate broadcast s rounds ago
    prev_err = float(torch.linalg.vector_norm(w - pop.w_star))
    # pending queue of finite arrivals that missed their round's buffer:
    # client id, born round, remaining time
    p_ids = np.zeros(0, np.int64)
    p_born = np.zeros(0, np.int64)
    p_t = np.zeros(0, np.float64)
    n_join = int(math.ceil(arrival.churn * rcfg.cohort_size))
    start = 0

    def snap_state(rnd: int) -> dict:
        return {
            "w": w, "prev_agg": prev_g if prev_g is not None else torch.zeros_like(w),
            "opt_state": state, "key": torch.tensor(rcfg.seed, dtype=torch.int64),
            "round": torch.tensor(rnd, dtype=torch.int64),
            "agg_hist": agg_hist, "w_hist": torch.stack(w_hist),
        }

    if resume is not False and resume is not None:
        if ckpt_dir is None:
            raise ValueError("resume=True needs ckpt_dir")
        rnd = None if resume is True else int(resume)
        if rnd is not None or round_engine.latest_round(ckpt_dir) is not None:
            snap, host = round_engine.load_snapshot(ckpt_dir, snap_state(0), rnd)
            w, state, prev_g = snap["w"], snap["opt_state"], snap["prev_agg"]
            agg_hist = snap["agg_hist"]
            w_hist = [snap["w_hist"][i] for i in range(H)]
            start = int(snap["round"])
            pend = host.get("pending", [])
            p_ids = np.asarray([int(p[0]) for p in pend], np.int64)
            p_born = np.asarray([int(p[1]) for p in pend], np.int64)
            p_t = np.asarray([float(p[2]) for p in pend], np.float64)
            history = list(host.get("history", []))
            prev_err = float(host.get("prev_err", prev_err))
            if scheduler is not None and host.get("scheduler") is not None:
                scheduler.load_state_dict(host["scheduler"])
            if host.get("timing_sched") is not None:
                timing_sched = ArrivalScheduler()
                timing_sched.load_state_dict(host["timing_sched"])

    for r in range(start, rcfg.num_rounds):
        attack = mixture.for_round(r, scheduler)
        ids = pop.sample_cohort(rcfg.seed, r, rcfg.cohort_size)
        ids_np = ids.cpu().numpy()
        t_new = pop.arrival_times(rcfg.seed, r, 0, ids, arrival).numpy()
        born_new = np.full(ids_np.shape, r, dtype=np.int64)
        if n_join > 0:  # mid-round churn: joiners land half a scale late
            jids = pop.sample_joiners(rcfg.seed, r, n_join)
            t_join = 0.5 * arrival.scale + pop.arrival_times(rcfg.seed, r, 2, jids,
                                                             arrival).numpy()
            ids_np = np.concatenate([ids_np, jids.cpu().numpy()])
            t_new = np.concatenate([t_new, t_join])
            born_new = np.concatenate([born_new, np.full(n_join, r, dtype=np.int64)])

        # merge the pending queue (insertion-first: they have waited)
        n_pend = len(p_ids)
        cand_ids = np.concatenate([p_ids, ids_np])
        cand_born = np.concatenate([p_born, born_new])
        cand_t = np.concatenate([p_t, t_new.astype(np.float64)])
        cand_prio = np.zeros(cand_t.shape, dtype=np.int64)
        byz_new = np.zeros(cand_t.shape, dtype=bool)
        byz_new[n_pend:] = pop.is_byzantine(torch.from_numpy(ids_np)).numpy()

        k = min(async_cfg.buffer_k, len(cand_t))
        mode = _resolve_arrival(attack)
        timing = mode or "honest"
        if mode == "greedy":
            if timing_sched is None:
                timing_sched = ArrivalScheduler()
            timing = timing_sched.pick(r)
        if mode is not None:
            _time_byzantine(cand_t, cand_prio, byz_new, timing, k, async_cfg.timeout)

        order = np.lexsort((np.arange(len(cand_t)), cand_prio, cand_t))
        n_finite = int(np.isfinite(cand_t[order]).sum())
        if n_finite >= k:
            t_close = float(cand_t[order[k - 1]])
        else:
            t_close = float(cand_t[order[n_finite - 1]]) if n_finite else 0.0
        if async_cfg.timeout is not None:
            t_close = min(t_close, async_cfg.timeout)
        buf = order[cand_t[order] <= t_close][:k]

        # finite non-buffered reports stay in flight; stale beyond the cap
        # (as of NEXT round) or infinite (dropped) are gone for good
        in_flight = np.isfinite(cand_t) & (r + 1 - cand_born <= async_cfg.max_staleness)
        in_flight[buf] = False
        p_ids, p_born = cand_ids[in_flight], cand_born[in_flight]
        p_t = cand_t[in_flight] - t_close

        s_vec = (r - cand_born[buf]).astype(np.int64)
        keep, weights, beta_eff = staleness_policies.apply_policy(
            async_cfg.policy, s_vec, knob=async_cfg.policy_knob,
            cap=async_cfg.policy_cap, beta=rcfg.beta)

        if len(buf) == 0:
            g = torch.zeros(dim, dtype=torch.float32, device=dev)  # nobody reported
        elif (not np.any(s_vec) and keep.all() and float(weights.min()) == 1.0
              and beta_eff == rcfg.beta and len(buf) == len(cand_t)
              and np.array_equal(cand_ids[buf], ids_np) and n_join == 0):
            # synchronous fast path: the buffer IS the fresh cohort in
            # cohort order and the policy is the identity — the sync
            # engine's own aggregation (bit-for-bit pin)
            g = sync_rounds.aggregate_cohort(pop, w, ids, rcfg, attack, prev_agg=prev_g,
                                             rnd=r)
        else:
            kept, s_kept, w_kept = buf[keep], s_vec[keep], weights[keep]
            groups, w_pol = [], []
            for s in np.unique(s_kept):  # fresh first
                sel = s_kept == s
                cids = torch.from_numpy(cand_ids[kept[sel]]).to(dev)
                groups.append(_group_rows(pop, w_hist[s], cids, rcfg, attack, agg_hist,
                                          int(s), r - int(s)))
                w_pol.append(w_kept[sel])
            rows = torch.cat(groups, dim=0)
            w_pol = np.concatenate(w_pol)
            if float(w_pol.min()) < 1.0:  # skip the multiply at identity
                rows = rows * torch.from_numpy(w_pol).to(dev, rows.dtype)[:, None]
            g = _aggregate_buffer(rows, rcfg, float(beta_eff))

        prev_g = g  # transmitted scale, as run_rounds
        agg_hist = torch.cat([g[None].to(agg_hist.dtype), agg_hist[:-1]], dim=0)
        if rcfg.local_steps > 1:
            g = g / torch.full_like(g, rcfg.local_steps)
        w, state = opt.update(g, state, w, torch.tensor(r, dtype=torch.int64))
        w_hist = [w] + w_hist[:-1]
        err = float(torch.linalg.vector_norm(w - pop.w_star))
        if scheduler is not None:
            scheduler.feedback(r, err - prev_err)
        if timing_sched is not None:
            timing_sched.feedback(r, err - prev_err)
        prev_err = err
        n_kept = int(keep.sum()) if len(buf) else 0
        history.append({
            "round": r,
            "attack": attack.name if attack is not None else "none",
            "grad_norm": float(torch.linalg.vector_norm(g)),
            "err": err,
            "duration": t_close,
            "buffer": n_kept,
            "staleness_mean": float(s_vec[keep].mean()) if n_kept else 0.0,
            "pending": len(p_ids),
            "timing": timing,
        })
        if ckpt_every and ckpt_dir and (r + 1) % ckpt_every == 0:
            round_engine.save_snapshot(ckpt_dir, snap_state(r + 1), host={
                "pending": [[int(i), int(b), float(t)] for i, b, t in zip(p_ids, p_born, p_t)],
                "history": history,
                "prev_err": prev_err,
                "scheduler": scheduler.state_dict() if scheduler is not None else None,
                "timing_sched": (timing_sched.state_dict()
                                 if timing_sched is not None else None),
            })
    return w, history
