"""Round engine: one round template under every round program, with
deterministic checkpoint/resume.

- :data:`RoundState` — the cross-round state (iterate, previous broadcast
  aggregate, compression residuals, optimizer state, base seed, round
  index), the exact snapshot the checkpoint serializes;
- :class:`RoundStages` — local work -> compression -> attack ->
  aggregation -> update, composed into one round body by
  :func:`make_round_body` (attacks see decoded transmitted values);
- :func:`run_scan` — a Python loop over rounds that writes a snapshot
  every ``ckpt_every`` rounds.

Determinism contract: every per-round random draw comes from a generator
seeded with (base seed, absolute round), and all cross-round state lives
in :data:`RoundState`, so resuming from the snapshot written after round
r-1 replays rounds r..R bit for bit.

The reference's jit/runner regimes have no counterpart (PyTorch runs
eagerly); its scheduled per-round loop (``run_scheduled``) waits for the
federated slice.
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
                  host: Optional[dict] = None) -> str:
    """Write the snapshot taken after round ``state["round"] - 1`` plus
    JSON host state into ``ckpt_dir/round_XXXXXXXX/`` and advance the
    LATEST marker atomically."""
    rnd = int(state["round"])
    d = _snapshot_dir(ckpt_dir, rnd)
    ckpt_lib.save(d, state, step=rnd, extra={"host": host or {}})
    tmp = os.path.join(ckpt_dir, _LATEST + ".tmp")
    with open(tmp, "w") as f:
        f.write(str(rnd))
    os.replace(tmp, os.path.join(ckpt_dir, _LATEST))
    return d


def load_snapshot(ckpt_dir: str, like: RoundState,
                  rnd: Optional[int] = None) -> Tuple[RoundState, dict]:
    """Restore ``(state, host)`` from the snapshot at round ``rnd``
    (default: the latest); ``like`` supplies structure and devices."""
    if rnd is None:
        rnd = latest_round(ckpt_dir)
        if rnd is None:
            raise FileNotFoundError(f"no engine snapshot under {ckpt_dir!r}")
    d = _snapshot_dir(ckpt_dir, rnd)
    state, _step = ckpt_lib.restore(d, like)
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
