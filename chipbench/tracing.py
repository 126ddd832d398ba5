"""The traced run's readings: synchronising host-clock spans around the
calls into the port's layers, and one profiler trace of bare steps.

Spans are taken from outside the program: a named module attribute (or
the optimizer's ``update``) is replaced by a wrapper that synchronises
the card, reads the host clock, calls it and synchronises again.  The
spans serialise the card with the host, so they run on steps of their
own, never on the steps the profiler or the model-FLOP rate read.  A name
that is missing fails the run: a span is never read as 0.

The profile summary is a copy of ``chip_smoke.profile_summary``'s raw
event path (device time and launches by kernel name), with the device's
busy time taken as the union of its activity intervals and the idle gaps
named by the host operation running through them; beside it, the device
time by the program's own spans (``chipbench/spans.py``).
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

from chipbench import spans

#: (module, attribute) of each span, by span name
SPANS = {"aggregate": ("repro_torch.rounds.distributed", "aggregate_by_strategy"),
         "attack": ("repro_torch.core.distributed", "_maybe_attack"),
         "select": ("repro_torch.core.aggregators", "aggregate_leaves")}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Per-step host-clock spans: ``ms[name]`` a list, one total a step."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on = False
        self.ms: Dict[str, List[float]] = defaultdict(list)
        self._step: Dict[str, float] = defaultdict(float)
        self.targets = {}
        for name, (mod, attr) in SPANS.items():
            module = importlib.import_module(mod)
            if not callable(getattr(module, attr, None)):
                raise AttributeError(f"span {name!r}: {mod}.{attr} is missing")
            self.targets[name] = (module, attr)

    def wrap(self, name: str, fn: Callable) -> Callable:
        """``fn`` timed under ``name`` while the spans are on."""
        def run(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(self.device)
            self._step[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    @contextlib.contextmanager
    def patched(self):
        """The module attributes of :data:`SPANS` wrapped, the spans on."""
        saved = {n: getattr(m, a) for n, (m, a) in self.targets.items()}
        for n, (m, a) in self.targets.items():
            setattr(m, a, self.wrap(n, saved[n]))
        self.on = True
        try:
            yield self
        finally:
            self.on = False
            for n, (m, a) in self.targets.items():
                setattr(m, a, saved[n])

    def step(self, fn: Callable[[], None]) -> None:
        """One step ``fn()`` between synchronisations, its spans kept."""
        self._step.clear()
        sync(self.device)
        t0 = time.perf_counter()
        fn()
        sync(self.device)
        self.ms["step"].append((time.perf_counter() - t0) * 1e3)
        for name in list(SPANS) + ["update"]:
            self.ms[name].append(self._step.get(name, 0.0))


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of ``gaps`` ((start, end) ns) by the innermost host operation
    running at each gap's middle (per thread, the latest-started open one;
    across threads, the latest started), "none" where no operation runs."""
    by_thread = defaultdict(list)
    for tid, s, e, name in host:
        by_thread[tid].append((s, e, name))
    out: Dict[str, float] = defaultdict(float)
    cursors = {}
    for tid, evs in by_thread.items():
        evs.sort(key=lambda x: (x[0], -x[1]))
        cursors[tid] = ([s for s, _, _ in evs], evs)
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        best: Optional[tuple] = None
        for starts, evs in cursors.values():
            i = bisect.bisect_right(starts, mid) - 1
            steps = 0
            while i >= 0 and steps < 256:  # walk back to the innermost open op
                s, e, name = evs[i]
                if e >= mid:
                    if best is None or s > best[0]:
                        best = (s, name)
                    break
                i -= 1
                steps += 1
        out[best[1] if best else "none"] += (ge - gs) / 1e9
    return out


def profile(fn: Callable[[], None], device: torch.device, top: int = 10) -> Dict:
    """One ``torch.profiler`` trace of ``fn()`` (CPU and CUDA activities):
    its host-clock length (``window_s``), the device's busy seconds (the
    union of its activity intervals), kernel launches (device activities
    other than memory copies and sets), device seconds by kernel name, the
    ``top`` kernels and the ``top`` idle gaps by host operation; and the
    program's spans (:func:`chipbench.spans.summary`: ``spans``,
    ``idle_spans``), where ``fn`` ran with them on.  The profiler's
    device copies of the spans are no work: they count nowhere, and no
    idle gap is named by a span here."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        window_s = time.perf_counter() - t0
    events = spans.events_of(prof.profiler.kineto_results.events())
    dev, host, kernels = [], [], defaultdict(float)
    launches = 0
    for e in events:
        if e.span:
            continue
        if e.device:
            dev.append((e.start, e.end))
            kernels[e.name] += (e.end - e.start) / 1e9
            if not e.name.startswith(("Memcpy", "Memset")):
                launches += 1
        elif not e.name.startswith(("cuda", "cu", "Memcpy", "Memset")):
            host.append((e.tid, e.start, e.end, e.name))
    dev.sort()
    busy = spans.union(dev)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    idle = _name_gaps(gaps, host) if gaps else {}
    ranked = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)
    by_span = spans.summary(events)
    return {"window_s": window_s, "busy_s": busy_s, "launches": launches,
            "kernel_s": dict(kernels),
            "device_ops": [[k[:120], v] for k, v in ranked[:top]],
            "idle_gaps": [[k[:120], v] for k, v in
                          sorted(idle.items(), key=lambda kv: kv[1], reverse=True)[:top]],
            "spans": by_span["spans"], "idle_spans": by_span["idle_spans"]}
