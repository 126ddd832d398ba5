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

On a mesh with a model axis (tensor parallelism) the engine serves on
the model shards: under a process group each rank holds its shards of the
params (:func:`repro_torch.launch.steps.tp_shard`) and its kv heads of the
pool, and serves the same stream as every other rank; on the in-process
mesh it holds the global view and each layer's model ranks run in turn.
Either way the greedy tokens are the argmax of the whole logits.

A frontend configuration (whisper, internvl2) is refused
(:func:`refuse_frontend`): the reference's engine prefills with no
frontend, so it serves neither, and the port adds no such feature.

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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map


def refuse_frontend(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a frontend configuration (whisper,
    internvl2): the reference's engine prefills every slot with no frontend
    and its adapter's loss takes none, so it cannot serve these models, and
    the port adds no serving feature the reference lacks."""
    if cfg.frontend != "none":
        raise ValueError(
            f"{cfg.name}: a model with the {cfg.frontend} frontend cannot be served: the "
            f"reference's serve engine prefills its slots with no frontend (frontend=None) "
            f"and its feedback adapter's loss takes none; train it with "
            f"repro_torch.launch.train")


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


class ModelShards:
    """How this process holds the served iterate on ``mesh``'s model axis.

    Under a process group with a model axis > 1 (``per_rank``) a rank holds
    its shards of every split leaf (chunk ``k`` of ``model`` along the
    leaf's dim of :func:`repro_torch.models.sharding.tp_dims`) and the
    other leaves whole; the flat vectors of the adaptation round (its
    (m, D_rank) rows, the aggregate) run over the rank's leaves in ravel
    order.  Otherwise (no mesh, model size 1, or the in-process mesh,
    which holds the global view) every method is the identity.

    ``gather`` / ``gather_flat`` rebuild the global tree / vector over the
    model axis (every rank of the group calls them together), ``cut`` /
    ``cut_flat`` take this rank's part of a global one, ``row_sum`` and
    ``norm`` complete a sum over the rank's columns across the model axis
    (a split leaf's columns psummed, a whole leaf's counted once), and
    ``writes`` says whether this process writes what every rank holds
    alike (global rank 0)."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        model = mesh_lib.model_size(mesh) if mesh is not None else 1
        self.per_rank = mesh is not None and mesh.per_rank and model > 1
        self.writes = mesh is None or mesh.rank == 0
        self.model, self.k = model, (mesh_lib.model_rank(mesh) if self.per_rank else 0)
        if self.per_rank:
            self.ctx = sharding.model_ctx(mesh)
            self.specs = steps.param_shardings(cfg, mesh)
            self.dim_tree = sharding.tp_dims(cfg, model)
            self.dims = tree_leaves(self.dim_tree)
            self.meta = T.meta_params(cfg)  # the global shapes
            self.rank_meta = steps.abstract_params(cfg, mesh)  # this rank's
            self.sizes = [t.numel() for t in tree_leaves(self.meta)]
            self.rank_sizes = [t.numel() for t in tree_leaves(self.rank_meta)]

    # -- parameter-shaped trees

    def piece(self, src, d: int, shape):
        """``src`` as the served leaf of ``shape`` takes it: itself where the
        shapes agree (a whole leaf, or a rank's shard given as it is), else
        this rank's chunk of the global leaf along ``d``."""
        if d >= 0 and tuple(src.shape) != tuple(shape):
            return src.detach().chunk(self.model, d)[self.k]
        return src

    def cut(self, params):
        """This process's copy of the global ``params`` (cloned)."""
        if not self.per_rank:
            return tree_map(lambda t: t.detach().clone(), params)
        shards = steps.tp_shard(tree_map(torch.Tensor.detach, params), self.specs, self.k,
                                self.model)
        return tree_map(lambda t, d: t.clone() if d < 0 else t, shards, self.dim_tree)

    def gather(self, params):
        """The global tree of this rank's ``params`` (a collective)."""
        if not self.per_rank:
            return params
        dims = iter(self.dims)

        def full(t):
            d = next(dims)
            return t if d < 0 else self.ctx.full(t, d)

        return tree_map(full, params)

    # -- flat vectors in ravel order (the round's rows and aggregate)

    @property
    def size(self) -> int:
        """D, the global iterate's coordinate count (under ``per_rank``)."""
        return sum(self.sizes)

    def _flat(self, x, sizes, metas, fn):
        """``x`` (..., D_x) split into its leaves' columns (``sizes``), each
        taken to ``fn(leaf columns shaped lead + the leaf's shape, the
        leaf's split dim in them)`` and raveled back, concatenated."""
        lead = tuple(x.shape[:-1])
        out = []
        for p, t, d in zip(torch.split(x, sizes, dim=-1), tree_leaves(metas), self.dims):
            p = p.reshape(lead + tuple(t.shape))
            out.append((p if d < 0 else fn(p, len(lead) + d)).reshape(lead + (-1,)))
        return torch.cat(out, dim=-1)

    def cut_flat(self, v):
        """This rank's columns (..., D_rank) of a global flat vector or of
        global rows (..., D)."""
        if not self.per_rank:
            return v
        return self._flat(v, self.sizes, self.meta,
                          lambda p, d: p.chunk(self.model, d)[self.k].contiguous())

    def gather_flat(self, v):
        """The global columns (..., D) of this rank's flat vector or rows
        (..., D_rank) (a collective)."""
        if not self.per_rank:
            return v
        return self._flat(v, self.rank_sizes, self.rank_meta, self.ctx.full)

    def _split_sums(self, x, fn):
        """(the sum of ``fn`` over the split leaves' columns, over the whole
        leaves' columns) of ``x`` (..., D_rank), each (...)."""
        split = whole = None
        for p, d in zip(torch.split(x, self.rank_sizes, dim=-1), self.dims):
            t = fn(p).sum(dim=-1)
            if d >= 0:
                split = t if split is None else split + t
            else:
                whole = t if whole is None else whole + t
        return split, whole

    def row_sum(self, x):
        """Each row's sum of a per-coordinate (m, D_rank) tensor over every
        column of the global rows: the split leaves' columns psummed over
        the model axis, the whole leaves' once."""
        split, whole = self._split_sums(x, lambda p: p)
        return self.ctx.reduce([split]) + whole

    def norm(self, v):
        """The float32 2-norm of the global vector of this rank's columns."""
        split, whole = self._split_sums(v.float(), torch.square)
        return torch.sqrt(self.ctx.reduce([split]) + whole)

    # -- round states: the iterate, the previous aggregate, the optimizer's
    # parameter-shaped moments; scalars and the (unused) residuals as they are

    def _state(self, state, tree_fn, flat_fn):
        def opt(t):
            if isinstance(t, dict) and sorted(t) == sorted(self.meta):
                return tree_fn(t)
            if isinstance(t, dict):
                return {k: opt(v) for k, v in t.items()}
            return t

        return dict(state, w=tree_fn(state["w"]), prev_agg=flat_fn(state["prev_agg"]),
                    opt_state=opt(state["opt_state"]))

    def gather_state(self, state):
        """The global round state of this rank's (a collective)."""
        if not self.per_rank:
            return state
        return self._state(state, self.gather, self.gather_flat)

    def cut_state(self, state):
        """This rank's round state of a global one."""
        if not self.per_rank:
            return state
        return self._state(state, self.cut, self.cut_flat)

    def template(self, state):
        """Empty tensors of the global round state's shapes, on the devices
        of this rank's ``state`` (a checkpoint restore's template)."""
        if not self.per_rank:
            return state

        def tree(t):
            it = iter(tree_leaves(self.meta))
            return tree_map(lambda x: x.new_empty(next(it).shape), t)

        return self._state(state, tree, lambda v: v.new_empty((sum(self.sizes),)))


class ServeEngine:
    """The fixed-slot continuous-batching pool, on the device of ``params``.

    The engine serves its own copy of ``params`` (the global iterate; under
    a process group with a model axis it keeps this rank's shards);
    :meth:`swap_params` copies a new iterate into it."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params, mesh=None):
        refuse_frontend(cfg)
        self.cfg = cfg
        self.scfg = scfg
        self.shards = ModelShards(cfg, mesh)
        self._prefill = steps.make_slot_prefill_step(cfg, scfg.cache_len, mesh)
        self._decode = steps.make_decode_pool_step(cfg, mesh)
        self._admit = steps.make_slot_admit_step()
        self.params = self.shards.cut(params)
        self.device = tree_leaves(self.params)[0].device
        self.params_version = 0
        self.pool = steps.init_slot_pool(cfg, scfg.slots, scfg.cache_len, device=self.device,
                                         mesh=mesh)
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
        """Hot-swap the served model between ticks: copy ``params`` (the
        global iterate, same tree and dtypes; under a process group with a
        model axis also this rank's shards of it, as the adapter holds
        them) into the served tensors in place, each rank its shard;
        in-flight slots keep their caches and continue under the new
        iterate.  Returns the new params version."""
        served = self.shards
        dims = iter(served.dims if served.per_rank else [-1] * len(tree_leaves(self.params)))

        def copy(dst, src):
            src = served.piece(src, next(dims), dst.shape)
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
