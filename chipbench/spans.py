"""Device time by the program's own spans (``repro_torch.trace``), from one
``torch.profiler`` trace taken with the port's tracing on.

Each device activity (kernel, copy, set) is attributed to a span as below.
The profiler also copies each span onto the device's timeline (a user
annotation named like the span): those copies are no work and are left
out, here and wherever launches or busy time are counted.

1. its launch: the torch operation linked to it (``linked_correlation_id``)
   or, failing that, the runtime call (``cudaLaunchKernel``, a copy or a
   set) with its ``correlation_id``; that gives a host thread and a time;
2. walking out from there on that thread, innermost event first, the first
   ``repro/`` span met takes it;
3. a backward node met first hands it to the forward: the span around the
   forward operation whose ``(start_thread_id, sequence_nr)`` is the
   node's ``(fwd_thread_id, sequence_nr)``, marked as backward.  Remat's
   recompute runs inside a backward node too, but inside the program's
   ``block`` span, which is met first: it counts as forward;
4. a thread with no span left (autograd's device thread) takes the
   innermost span open at that time on another thread, latest started
   first: the caller waiting in its backward;
5. otherwise the activity is "unspanned".

A span's parent is the next span out on its thread, else (rule 4) the one
open on another thread when it started, so the recompute's spans nest
under the worker whose backward ran them.  A span's self time is what it
was given; its subtree time adds its descendants'.  The idle gaps between
device activities are named by the innermost span open at each gap's
middle.  Nothing here imports the port.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "repro/"
UNSPANNED = "unspanned"
_BACKWARD = "autograd::engine::evaluate_function: "
_RUNTIME = ("cuda", "cu")  # the runtime's and the driver's calls, by name


@dataclasses.dataclass(eq=False)
class Event:
    """One event of a trace; times in ns."""

    name: str
    tid: int
    start: int
    end: int
    seq: int = -1  # sequence_nr
    fwd_tid: int = 0  # fwd_thread_id: > 0 on a backward node
    corr: int = 0  # correlation_id
    linked: int = 0  # linked_correlation_id
    device: bool = False  # a device activity
    parent: Optional["Event"] = dataclasses.field(default=None, repr=False)

    @property
    def span(self) -> bool:
        return self.name.startswith(PREFIX)

    @property
    def backward(self) -> bool:
        return self.name.startswith(_BACKWARD) or (self.seq >= 0 and self.fwd_tid > 0)

    @property
    def forward_op(self) -> bool:
        return self.seq >= 0 and not self.backward


def events_of(kineto_events) -> List[Event]:
    """:class:`Event` s of ``prof.profiler.kineto_results.events()``."""
    from torch.autograd import DeviceType

    out = []
    for e in kineto_events:
        s = e.start_ns()
        out.append(Event(e.name(), e.start_thread_id(), s, s + e.duration_ns(),
                         e.sequence_nr(), e.fwd_thread_id(), e.correlation_id(),
                         e.linked_correlation_id(), e.device_type() == DeviceType.CUDA))
    return out


def union(intervals):
    """Merged (start, end) intervals of the sorted ``intervals``."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _Threads:
    """The host operations of each thread as a tree (a parent a nesting)."""

    def __init__(self, ops: Iterable[Event]):
        by = defaultdict(list)
        for e in ops:
            by[e.tid].append(e)
        self.ops, self.starts, self.spans = {}, {}, {}
        for tid, evs in by.items():
            evs.sort(key=lambda e: (e.start, -e.end))
            stack: List[Event] = []
            for e in evs:
                while stack and stack[-1].end <= e.start:
                    stack.pop()
                e.parent = stack[-1] if stack else None
                stack.append(e)
            self.ops[tid] = evs
            self.starts[tid] = [e.start for e in evs]
            spans = [e for e in evs if e.span]
            self.spans[tid] = (spans, [e.start for e in spans])

    def innermost(self, tid: int, t: int) -> Optional[Event]:
        """The innermost operation of thread ``tid`` open at ``t``."""
        if tid not in self.ops:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        e = self.ops[tid][i] if i >= 0 else None
        while e is not None and e.end < t:
            e = e.parent
        return e

    def open_span(self, t: int, skip_tid: Optional[int] = None,
                  before: Optional[int] = None) -> Optional[Event]:
        """The innermost span open at ``t`` on any thread but ``skip_tid``,
        the latest started across threads (started before ``before``)."""
        best = None
        for tid, (spans, starts) in self.spans.items():
            if tid == skip_tid:
                continue
            i = bisect.bisect_right(starts, t) - 1
            e = spans[i] if i >= 0 else None
            while e is not None and (e.end < t or (before is not None and e.start >= before)):
                e = e.parent
                while e is not None and not e.span:
                    e = e.parent
            if e is not None and (best is None or e.start > best.start):
                best = e
        return best


class Attribution:
    """Device activities of one trace by span (module docstring)."""

    def __init__(self, events: List[Event]):
        self.activities = [e for e in events if e.device and not e.span]
        runtime = [e for e in events if not e.device and e.name.startswith(_RUNTIME)]
        ops = [e for e in events if not e.device and not e.name.startswith(_RUNTIME)]
        self.threads = _Threads(ops)
        self.by_corr = {e.corr: e for e in ops if e.corr}
        self.launch = {e.corr: e for e in runtime}
        self.forward = {}  # (thread, sequence_nr) -> the innermost forward op
        for e in ops:
            if e.forward_op:
                key = (e.tid, e.seq)
                if key not in self.forward or e.start >= self.forward[key].start:
                    self.forward[key] = e
        self._parent: Dict[int, Optional[Event]] = {}

    def _origin(self, a: Event) -> Optional[Tuple[Optional[Event], int, int]]:
        """(the innermost host operation, thread, time) of ``a``'s launch,
        None where the trace holds no launch of it."""
        op = self.by_corr.get(a.linked)
        if op is None:
            r = self.launch.get(a.corr)
            if r is None:
                return None
            op = self.by_corr.get(r.linked)
            if op is None:
                return self.threads.innermost(r.tid, r.start), r.tid, r.start
        return op, op.tid, op.start

    def owner(self, start: Optional[Event], tid: int, t: int,
              depth: int = 0) -> Tuple[Optional[Event], bool]:
        """(span, backward) of a point whose innermost operation is
        ``start``, on thread ``tid`` at ``t`` (rules 2-4)."""
        crossed = False
        e = start
        while e is not None:
            if e.span:
                return e, crossed
            if e.backward:
                fwd = self.forward.get((e.fwd_tid, e.seq))
                if fwd is not None and depth < 4:
                    span, _ = self.owner(fwd, fwd.tid, fwd.start, depth + 1)
                    if span is not None:
                        return span, True
                crossed = True
            e = e.parent
        return self.threads.open_span(t, skip_tid=tid), crossed

    def span_parent(self, s: Event) -> Optional[Event]:
        """The span around ``s``: the next span out on its thread, else the
        innermost one open on another thread when it started."""
        if id(s) not in self._parent:
            e = s.parent
            while e is not None and not e.span:
                e = e.parent
            if e is None:
                e = self.threads.open_span(s.start, skip_tid=s.tid, before=s.start)
            self._parent[id(s)] = e
        return self._parent[id(s)]

    def chain(self, s: Event) -> List[str]:
        """The span names from ``s`` out, each once."""
        names, e = [], s
        while e is not None and len(names) < 64:
            name = e.name[len(PREFIX):]
            if name not in names:
                names.append(name)
            e = self.span_parent(e)
        return names

    def table(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``calls``, ``self_s``, ``subtree_s``,
        ``backward_s`` (the part of ``self_s`` given through backward
        nodes); ``unspanned`` for what no span took."""
        out = defaultdict(lambda: {"calls": 0, "self_s": 0.0, "subtree_s": 0.0,
                                   "backward_s": 0.0})
        for spans, _ in self.threads.spans.values():
            for s in spans:
                out[s.name[len(PREFIX):]]["calls"] += 1
        chains: Dict[int, List[str]] = {}
        for a in self.activities:
            dur = (a.end - a.start) / 1e9
            origin = self._origin(a)
            span, bwd = self.owner(*origin) if origin else (None, False)
            if span is None:
                row = out[UNSPANNED]
                row["self_s"] += dur
                row["subtree_s"] += dur
                row["backward_s"] += dur if bwd else 0.0
                continue
            if id(span) not in chains:
                chains[id(span)] = self.chain(span)
            names = chains[id(span)]
            out[names[0]]["self_s"] += dur
            if bwd:
                out[names[0]]["backward_s"] += dur
            for n in names:
                out[n]["subtree_s"] += dur
        return dict(out)

    def idle(self, gaps: Iterable[Tuple[int, int]]) -> Dict[str, float]:
        """Seconds of ``gaps`` ((start, end) ns) by the innermost span open
        at each gap's middle (across threads, the latest started)."""
        out: Dict[str, float] = defaultdict(float)
        for gs, ge in gaps:
            s = self.threads.open_span((gs + ge) // 2)
            out[s.name[len(PREFIX):] if s is not None else "none"] += (ge - gs) / 1e9
        return dict(out)


def summary(events: List[Event], top: int = 16) -> Dict:
    """The ``spans`` table ([name, calls, self s, subtree s, backward s],
    by subtree time), the ``idle_spans`` ([name, s], the ``top`` largest),
    and the totals they are checked against: ``busy_s`` (the union of the
    device's activity) and ``activity_s`` (the sum of their durations)."""
    att = Attribution(events)
    busy = union(sorted((a.start, a.end) for a in att.activities))
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    rows = sorted(([n, r["calls"], r["self_s"], r["subtree_s"], r["backward_s"]]
                   for n, r in att.table().items()), key=lambda r: -r[3])
    idle = sorted(att.idle(gaps).items(), key=lambda kv: -kv[1])[:top]
    return {"spans": rows, "idle_spans": [[k, v] for k, v in idle],
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "activity_s": sum(a.end - a.start for a in att.activities) / 1e9}


def metric_values(spans: List[list], counts: Dict[str, float], steps: int) -> Dict[str, float]:
    """Per step, from :func:`summary`'s ``spans`` and the program's
    counters (``repro_torch.trace.take_counts``): device ms of the layers
    and the kept shares; a metric whose span or counter is absent is left
    out."""
    sub = {r[0]: r[3] for r in spans}
    ms = {n: 1e3 * s / steps for n, s in sub.items()}
    out = {}
    for metric, name in (("grads_dev_ms", "worker.grads"), ("attn_dev_ms", "attention"),
                         ("attack_dev_ms", "attack"), ("update_dev_ms", "update")):
        if name in ms:
            out[metric] = ms[name]
    if "moe.route" in ms or "moe.experts" in ms:
        out["moe_dev_ms"] = ms.get("moe.route", 0.0) + ms.get("moe.experts", 0.0)
    if "aggregate" in ms:
        out["aggregate_dev_ms"] = ms["aggregate"] - ms.get("attack", 0.0)
    if counts.get("attn.scores"):
        out["attn_kept_share"] = 100.0 * counts["attn.kept"] / counts["attn.scores"]
    if counts.get("moe.pairs"):
        out["moe_dropped_share"] = 100.0 * (1.0 - counts["moe.kept"] / counts["moe.pairs"])
    return out


def read_metric(t, name: str) -> Optional[float]:
    """The metric ``name`` of :func:`metric_values` of a traced run's
    profile (``kinds.train.Trace``): None where the run had no card, or
    the profile no such span or counter."""
    p = t.profile
    if t.device_type != "cuda" or not p.get("spans"):
        return None
    return metric_values(p["spans"], p.get("counts", {}), p["steps"]).get(name)
