"""Round engine: one round template under every round program, with
deterministic checkpoint/resume.

- :data:`RoundState` — the cross-round state (iterate, previous broadcast
  aggregate, compression residuals, optimizer state, base seed, round
  index), the exact snapshot the checkpoint serializes;
- :class:`RoundStages` — local work -> compression -> attack ->
  aggregation -> update, composed into one round body by
  :func:`make_round_body` (attacks see decoded transmitted values);
- :func:`run_scan` — a Python loop over rounds that writes a snapshot
  every ``ckpt_every`` rounds;
- :func:`run_scheduled` — the host driver for per-round attack schedules
  (``fed.rounds.AttackMixture``, including the greedy adaptive
  adversary): it picks each round's attack, runs a per-attack cached
  round function, records history, feeds the scheduler its damage signal
  and snapshots state plus host state (history, scheduler table).

Determinism contract: every per-round random draw comes from a generator
seeded with (base seed, absolute round), and all cross-round state lives
in :data:`RoundState`, so resuming from the snapshot written after round
r-1 replays rounds r..R bit for bit.

The reference's jit/runner regimes have no counterpart (PyTorch runs
eagerly).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.tree import tree_map

#: The engine's cross-round state, a plain dict tree:
#:   w         the shared iterate
#:   prev_agg  the previous round's broadcast aggregate (zeros before round 0)
#:   comp_res  compression error-feedback residual (``()`` when stateless)
#:   opt_state optimizer state (``()`` for plain GD updates)
#:   key       the run's base seed (int64 scalar; per-round draws fold the round)
#:   round     int64 scalar — the NEXT round to execute
RoundState = Dict[str, Any]


def make_state(
    w0,
    *,
    prev_agg=None,
    comp_res=(),
    opt_state=(),
    seed: int = 0,
    rnd: int = 0,
) -> RoundState:
    """Fresh engine state at round ``rnd``.  Leaves are CLONED: the engine
    owns its state, so the caller's ``w0`` is never aliased."""
    if prev_agg is None:
        prev_agg = tree_map(torch.zeros_like, w0)
    return tree_map(lambda t: t.clone(), {
        "w": w0,
        "prev_agg": prev_agg,
        "comp_res": comp_res,
        "opt_state": opt_state,
        "key": torch.tensor(seed, dtype=torch.int64),
        "round": torch.tensor(rnd, dtype=torch.int64),
    })


@dataclasses.dataclass(frozen=True)
class RoundStages:
    """The pluggable stages of one communication round.

    ``local_work(w, r) -> payload``: the per-worker stacked payload.
    ``aggregate(payload) -> agg``: the robust aggregation.
    ``update(w, opt_state, agg, r) -> (w_new, opt_state)``: the server step.
    ``compress(payload, comp_res, r) -> (payload, comp_res)``: the wire
    codec (None = none; runs BEFORE the attack).
    ``attack(payload, prev_agg, r) -> payload``: Byzantine row replacement.
    ``emit(w_new, agg) -> outs``: per-round outputs (None emits a zero).
    """

    local_work: Callable
    aggregate: Callable
    update: Callable
    compress: Optional[Callable] = None
    attack: Optional[Callable] = None
    emit: Optional[Callable] = None


def make_round_body(stages: RoundStages) -> Callable:
    """Compose the stages into ``body(state, r) -> (state, outs)``."""

    def body(state: RoundState, r: int):
        payload = stages.local_work(state["w"], r)
        comp_res = state["comp_res"]
        if stages.compress is not None:
            payload, comp_res = stages.compress(payload, comp_res, r)
        if stages.attack is not None:
            payload = stages.attack(payload, state["prev_agg"], r)
        agg = stages.aggregate(payload)
        w_new, opt_state = stages.update(state["w"], state["opt_state"], agg, r)
        outs = stages.emit(w_new, agg) if stages.emit is not None else torch.zeros(())
        new_state = dict(state, w=w_new, prev_agg=agg, comp_res=comp_res,
                         opt_state=opt_state, round=torch.tensor(r + 1))
        return new_state, outs

    return body


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------

_LATEST = "LATEST"


def _snapshot_dir(ckpt_dir: str, rnd: int) -> str:
    return os.path.join(ckpt_dir, f"round_{rnd:08d}")


def snapshot_rounds(ckpt_dir: str) -> List[int]:
    """All round indices with a snapshot under ``ckpt_dir`` (ascending)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(name[len("round_"):]) for name in os.listdir(ckpt_dir)
        if name.startswith("round_")
        and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")))


def latest_round(ckpt_dir: str) -> Optional[int]:
    """Round index of the most recent snapshot (None when no snapshot)."""
    marker = os.path.join(ckpt_dir, _LATEST)
    if os.path.exists(marker):
        with open(marker) as f:
            return int(f.read().strip())
    rounds = snapshot_rounds(ckpt_dir)
    return rounds[-1] if rounds else None


def save_snapshot(ckpt_dir: str, state: RoundState,
                  host: Optional[dict] = None, layout=None) -> str:
    """Write the snapshot taken after round ``state["round"] - 1`` plus
    JSON host state into ``ckpt_dir/round_XXXXXXXX/`` and advance the
    LATEST marker atomically.

    ``layout`` (duck-typed: ``gather_state``, ``writes``; e.g.
    :class:`repro_torch.serve.engine.ModelShards`) holds a state split over
    the ranks of a model axis: the global state is gathered (every rank
    calls this together) and written once, by the rank that ``writes``."""
    rnd = int(state["round"])
    d = _snapshot_dir(ckpt_dir, rnd)
    if layout is not None:
        state = layout.gather_state(state)
        if not layout.writes:
            return d
    ckpt_lib.save(d, state, step=rnd, extra={"host": host or {}})
    tmp = os.path.join(ckpt_dir, _LATEST + ".tmp")
    with open(tmp, "w") as f:
        f.write(str(rnd))
    os.replace(tmp, os.path.join(ckpt_dir, _LATEST))
    return d


def load_snapshot(ckpt_dir: str, like: RoundState,
                  rnd: Optional[int] = None, layout=None) -> Tuple[RoundState, dict]:
    """Restore ``(state, host)`` from the snapshot at round ``rnd``
    (default: the latest); ``like`` supplies structure and devices.  With
    ``layout`` (``template``, ``cut_state``) the snapshot holds the global
    state and ``like`` this rank's part: the global state is read and this
    rank's part cut from it."""
    if rnd is None:
        rnd = latest_round(ckpt_dir)
        if rnd is None:
            raise FileNotFoundError(f"no engine snapshot under {ckpt_dir!r}")
    d = _snapshot_dir(ckpt_dir, rnd)
    if layout is None:
        state, _step = ckpt_lib.restore(d, like)
    else:
        state = layout.cut_state(ckpt_lib.restore(d, layout.template(like))[0])
    return state, ckpt_lib.load_extra(d).get("host", {})


def _maybe_resume(state: RoundState, ckpt_dir: Optional[str],
                  resume: Union[bool, int]) -> Tuple[RoundState, dict, int]:
    """``resume`` is False (fresh), True (latest snapshot; a fresh start
    when there is none) or an int round (that snapshot)."""
    if resume is False or resume is None:
        return state, {}, int(state["round"])
    if ckpt_dir is None:
        raise ValueError("resume=True needs ckpt_dir")
    rnd = None if resume is True else int(resume)
    if rnd is None and latest_round(ckpt_dir) is None:
        return state, {}, int(state["round"])
    state, host = load_snapshot(ckpt_dir, state, rnd)
    return state, host, int(state["round"])


def run_scan(
    stages_or_body: Union[RoundStages, Callable],
    state: RoundState,
    num_rounds: int,
    *,
    ckpt_every: int = 0,
    ckpt_dir: Optional[str] = None,
    resume: Union[bool, int] = False,
) -> Tuple[RoundState, Any]:
    """Run rounds ``state["round"]..num_rounds``; returns ``(state,
    stacked outs)`` (outs ``None`` when resumed at or after the end).
    With ``ckpt_every`` and ``ckpt_dir`` a snapshot is written after
    every ``ckpt_every``-th round except the last."""
    body = (make_round_body(stages_or_body)
            if isinstance(stages_or_body, RoundStages) else stages_or_body)
    state, _host, r = _maybe_resume(state, ckpt_dir, resume)
    outs: List[Any] = []
    while r < num_rounds:
        state, out = body(state, r)
        outs.append(out)
        r += 1
        if ckpt_every and ckpt_dir and r % ckpt_every == 0 and r < num_rounds:
            save_snapshot(ckpt_dir, state)
    if not outs:
        return state, None
    return state, tree_map(lambda *xs: torch.stack(xs), *outs)


def run_scheduled(
    round_fn_for: Callable,
    state: RoundState,
    num_rounds: int,
    *,
    mixture=None,
    record: Callable,
    damage: Optional[Callable] = None,
    init_entry: Optional[dict] = None,
    ckpt_every: int = 0,
    ckpt_dir: Optional[str] = None,
    resume: Union[bool, int] = False,
) -> Tuple[RoundState, List[dict]]:
    """Host driver for per-round attack schedules; returns (state, history).

    ``round_fn_for(attack) -> fn(state, r) -> (state, extras)`` supplies
    the round executor for one attack configuration (cached per attack).
    ``record(r, attack, state, extras)`` builds the history entry;
    ``damage(entry, prev_entry)`` is the greedy scheduler's reward (the
    public drift every worker can observe); ``init_entry`` seeds
    ``prev_entry`` for round 0.

    Every ``ckpt_every`` rounds the :data:`RoundState` snapshot is written
    with the host state — the history so far and the scheduler's damage
    table — so a resumed run continues the SAME adversary and returns the
    full-run history.
    """
    scheduler = mixture.make_scheduler() if mixture is not None else None
    history: List[dict] = []
    prev_entry = init_entry
    state, host, r0 = _maybe_resume(state, ckpt_dir, resume)
    if host:
        history = list(host.get("history", []))
        if history:
            prev_entry = history[-1]
        if scheduler is not None and host.get("scheduler") is not None:
            scheduler.load_state_dict(host["scheduler"])
    fn_cache: Dict[Any, Callable] = {}
    for r in range(r0, num_rounds):
        attack = mixture.for_round(r, scheduler) if mixture is not None else None
        cache_key = _attack_cache_key(attack)
        fn = fn_cache.get(cache_key)
        if fn is None:
            fn = fn_cache[cache_key] = round_fn_for(attack)
        state, extras = fn(state, r)
        entry = record(r, attack, state, extras)
        if scheduler is not None and damage is not None:
            scheduler.feedback(r, damage(entry, prev_entry))
        prev_entry = entry
        history.append(entry)
        if ckpt_every and ckpt_dir and (r + 1) % ckpt_every == 0:
            save_snapshot(ckpt_dir, state, host={
                "history": history,
                "scheduler": scheduler.state_dict() if scheduler else None,
            })
    return state, history


def _attack_cache_key(attack):
    """Hashable identity of one attack configuration: (name, alpha,
    strength), what the per-attack round functions are cached on."""
    if attack is None:
        return None
    from repro_torch.rounds import comm

    spec, alpha, strength = comm.resolve_attack(attack)
    return (None if spec is None else spec.name, alpha, strength)
