"""Continuous-batching inference engine over the serving steps (the
reference's ``repro.serve.engine``).

The engine owns a FIXED pool of decode slots whose caches are allocated
once on the device (:func:`repro_torch.launch.steps.init_slot_pool`).  One
simulated time *tick* = one batched decode step of the whole pool:

- **admit**: a queued request prefills at the fixed prompt bucket (batch
  1) and its cache is copied into the free slot in place;
- **tick**: every slot decodes at its own position; idle lanes decode
  garbage against their masked caches (a constant pool shape is the
  continuous-batching trade) and their outputs are ignored;
- **retire**: a slot frees on EOS or its generation budget, and the next
  admit reuses it without touching the others.

Greedy decoding keeps the stream deterministic: a request's tokens are a
function of (params, prompt), independent of slot placement and pool
size.

``swap_params`` hot-swaps the served model between ticks without dropping
in-flight slots: the new iterate is copied into the served tensors, whose
shapes and dtypes it keeps.  The reference's "no recompile" contract has
no meaning without jit; its counterpart here is :meth:`ServeEngine.storage_kept`:
the served parameters and the pool keep their storage across admits,
retires and swaps.

Time model: arrivals are simulated times in ticks (one decode step = one
time unit), made by :mod:`repro_torch.serve.traffic`.  When the pool is
empty and no arrival is due, :func:`serve_stream` fast-forwards the clock
to the next arrival.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape knobs: ``slots`` decode lanes, prompts bucketed to
    ``prompt_len``, at most ``max_new`` generated tokens per request (the
    per-slot cache budget is ``prompt_len + max_new``), optional ``eos_id``
    early retirement (-1 = length-based only) and the metrics window in
    ticks."""

    slots: int = 4
    prompt_len: int = 16
    max_new: int = 16
    eos_id: int = -1
    window: int = 64  # per-window throughput/latency metrics period

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.prompt_len < 1 or self.max_new < 1:
            raise ValueError("prompt_len and max_new must be >= 1")

    @property
    def cache_len(self) -> int:
        return self.prompt_len + self.max_new


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request of the simulated stream."""

    rid: int
    uid: int
    shard: int  # gradient shard this user's feedback reports into
    arrival: float  # simulated arrival time, in ticks
    prompt: np.ndarray  # (prompt_len,) int32
    gen_len: int  # generation budget, <= ServeConfig.max_new


@dataclasses.dataclass(frozen=True)
class Completed:
    """A served request: the response plus its latency bookkeeping."""

    request: Request
    response: np.ndarray  # (gen,) int32 generated tokens
    admitted: int  # tick the request entered a slot
    finished: int  # tick the last token was produced
    params_version: int  # hot-swap generation the request finished under

    @property
    def latency(self) -> float:
        return self.finished - self.request.arrival

    @property
    def queue_wait(self) -> float:
        return self.admitted - self.request.arrival


class _Slot:
    """Host-side slot metadata (device state lives in the pool caches)."""

    __slots__ = ("req", "tokens", "admitted")

    def __init__(self):
        self.req: Optional[Request] = None
        self.tokens: List[int] = []
        self.admitted = 0

    @property
    def active(self) -> bool:
        return self.req is not None


class ServeMetrics:
    """Per-window throughput/latency accounting.

    A window closes every ``ServeConfig.window`` ticks; each entry records
    generated tokens, wall seconds, tokens/s, mean pool occupancy, and the
    p50/p99 latency (in ticks) of the requests that COMPLETED inside the
    window.  A tick's wall time ends when its next tokens are on the host
    (which waits for the device)."""

    def __init__(self, window: int, slots: int):
        self.window = window
        self.slots = slots
        self.windows: List[Dict[str, float]] = []
        self._reset()
        self.total_tokens = 0
        self.total_wall = 0.0

    def _reset(self):
        self._tokens = 0
        self._active = 0
        self._ticks = 0
        self._wall = 0.0
        self._lat: List[float] = []

    def record_tick(self, active: int, tokens: int, wall_s: float, tick: int):
        self._tokens += tokens
        self._active += active
        self._ticks += 1
        self._wall += wall_s
        self.total_tokens += tokens
        self.total_wall += wall_s
        if (tick + 1) % self.window == 0:
            self.close_window()

    def record_completion(self, done: Completed):
        self._lat.append(done.latency)

    def close_window(self):
        if self._ticks == 0:
            return
        lat = np.asarray(self._lat) if self._lat else np.zeros((0,))
        self.windows.append({
            "window": len(self.windows),
            "ticks": self._ticks,
            "tokens": self._tokens,
            "wall_s": self._wall,
            "tok_per_s": self._tokens / self._wall if self._wall > 0 else 0.0,
            "occupancy": self._active / (self._ticks * self.slots),
            "completed": len(self._lat),
            "p50_latency": float(np.percentile(lat, 50)) if len(lat) else 0.0,
            "p99_latency": float(np.percentile(lat, 99)) if len(lat) else 0.0,
        })
        self._reset()


def latency_stats(completed: List[Completed]) -> Dict[str, float]:
    """p50/p99 end-to-end latency and queue wait over a request set."""
    if not completed:
        return {"p50_latency": 0.0, "p99_latency": 0.0, "p50_wait": 0.0,
                "p99_wait": 0.0}
    lat = np.asarray([c.latency for c in completed], np.float64)
    wait = np.asarray([c.queue_wait for c in completed], np.float64)
    return {
        "p50_latency": float(np.percentile(lat, 50)),
        "p99_latency": float(np.percentile(lat, 99)),
        "p50_wait": float(np.percentile(wait, 50)),
        "p99_wait": float(np.percentile(wait, 99)),
    }


def _pointers(tree) -> List[int]:
    return [t.data_ptr() for t in tree_leaves(tree)]


class ServeEngine:
    """The fixed-slot continuous-batching pool, on the device of ``params``.

    The engine serves its own copy of ``params``; :meth:`swap_params`
    copies a new iterate into it."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params):
        self.cfg = cfg
        self.scfg = scfg
        self.params = tree_map(lambda t: t.detach().clone(), params)
        self.device = tree_leaves(self.params)[0].device
        self.params_version = 0
        self._prefill = steps.make_slot_prefill_step(cfg, scfg.cache_len)
        self._decode = steps.make_decode_pool_step(cfg)
        self._admit = steps.make_slot_admit_step()
        self.pool = steps.init_slot_pool(cfg, scfg.slots, scfg.cache_len, device=self.device)
        self._storage = {"params": _pointers(self.params), "pool": _pointers(self.pool)}
        S = scfg.slots
        self.slots = [_Slot() for _ in range(S)]
        # host-side lane state fed to the pool step each tick
        self._tok = np.zeros((S,), np.int32)
        self._pos = np.zeros((S,), np.int64)
        self.tick = 0
        self.metrics = ServeMetrics(scfg.window, S)

    # ------------------------------------------------------------- state

    def num_active(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def storage_kept(self) -> Dict[str, bool]:
        """Whether the served parameters and the pool caches still live in
        the storage allocated at construction (the counterpart of the
        reference's one-executable-per-step contract)."""
        return {"params": _pointers(self.params) == self._storage["params"],
                "pool": _pointers(self.pool) == self._storage["pool"]}

    def swap_params(self, params) -> int:
        """Hot-swap the served model between ticks: copy ``params`` (same
        tree, shapes and dtypes) into the served tensors; in-flight slots
        keep their caches and continue under the new iterate.  Returns the
        new params version."""
        def copy(dst, src):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"swap_params: {tuple(src.shape)} {src.dtype} does not fit "
                                 f"the served {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)

        with torch.no_grad():
            tree_map(copy, self.params, params)
        self.params_version += 1
        return self.params_version

    # ------------------------------------------------------------- admit

    def admit(self, slot: int, req: Request) -> Optional[Completed]:
        """Prefill ``req`` into a free slot.  Returns the completion
        immediately when the budget is a single token (it never enters
        the decode pool)."""
        if self.slots[slot].active:
            raise ValueError(f"slot {slot} is busy")
        if req.prompt.shape != (self.scfg.prompt_len,):
            raise ValueError(f"prompt shape {req.prompt.shape}, want ({self.scfg.prompt_len},)")
        if not 1 <= req.gen_len <= self.scfg.max_new:
            raise ValueError(f"gen_len {req.gen_len} outside [1, {self.scfg.max_new}]")
        prompt = torch.as_tensor(req.prompt, dtype=torch.int64, device=self.device)[None, :]
        logits, cache = self._prefill(self.params, prompt)
        first = int(torch.argmax(logits[0, -1].float()))
        s = self.slots[slot]
        s.req = req
        s.tokens = [first]
        s.admitted = self.tick
        if self._finished(s):
            return self._retire(slot)
        self._admit(self.pool, cache, slot)
        self._tok[slot] = first
        self._pos[slot] = self.scfg.prompt_len
        return None

    def _finished(self, s: _Slot) -> bool:
        if len(s.tokens) >= s.req.gen_len:
            return True
        return self.scfg.eos_id >= 0 and s.tokens[-1] == self.scfg.eos_id

    def _retire(self, slot: int) -> Completed:
        s = self.slots[slot]
        done = Completed(
            request=s.req,
            response=np.asarray(s.tokens, np.int32),
            admitted=s.admitted,
            finished=self.tick,
            params_version=self.params_version,
        )
        s.req, s.tokens = None, []
        self.metrics.record_completion(done)
        return done

    # -------------------------------------------------------------- tick

    def step(self) -> List[Completed]:
        """One decode tick of the whole pool; returns retired requests."""
        t0 = time.perf_counter()
        nxt, _ = self._decode(
            self.params, torch.as_tensor(self._tok, device=self.device), self.pool,
            torch.as_tensor(self._pos, device=self.device))
        nxt = nxt.cpu().numpy()
        wall = time.perf_counter() - t0
        active = self.num_active()
        done: List[Completed] = []
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            s.tokens.append(int(nxt[i]))
            self._tok[i] = nxt[i]
            self._pos[i] += 1
            if self._finished(s):
                done.append(self._retire(i))
        # every active lane produced one token this tick
        self.metrics.record_tick(active, active, wall, self.tick)
        self.tick += 1
        return done


def serve_stream(
    engine: ServeEngine,
    requests: List[Request],
    *,
    adapter: Any = None,
    on_complete: Optional[Callable[[Completed], None]] = None,
    max_ticks: int = 1_000_000,
) -> List[Completed]:
    """Drive the engine over a simulated arrival stream to completion.

    Each loop iteration: enqueue due arrivals, admit FIFO into free slots,
    decode one pool tick, retire finishers, and give ``adapter``
    (duck-typed: ``offer(Completed)`` + ``maybe_round(engine)``) the
    chance to fire a robust continual-adaptation round on its cadence —
    which hot-swaps the engine's params WITHOUT draining the pool.  When
    the pool is idle and no arrival is due, the clock fast-forwards to the
    next arrival.
    """
    pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
    queue: deque = deque()
    completed: List[Completed] = []

    def _complete(done: Completed):
        completed.append(done)
        if on_complete is not None:
            on_complete(done)
        if adapter is not None:
            adapter.offer(done)

    while pending or queue or engine.num_active():
        if engine.tick >= max_ticks:
            raise RuntimeError(
                f"serve_stream exceeded max_ticks={max_ticks} with "
                f"{len(pending)} pending / {len(queue)} queued")
        while pending and pending[0].arrival <= engine.tick:
            queue.append(pending.popleft())
        for slot in engine.free_slots():
            if not queue:
                break
            done = engine.admit(slot, queue.popleft())
            if done is not None:
                _complete(done)
        if engine.num_active() == 0:
            if queue:
                continue  # instant completions freed lanes mid-admit
            if not pending:
                break
            engine.tick = max(engine.tick + 1,
                              int(math.ceil(pending[0].arrival)))
            continue
        for done in engine.step():
            _complete(done)
        if adapter is not None:
            adapter.maybe_round(engine)
    engine.metrics.close_window()
    return completed
