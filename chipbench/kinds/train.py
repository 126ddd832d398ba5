"""A closed-loop robust training cell on the port's in-process mesh.

Set-up (``setup_s``, from process start): the port's training state from
``repro_torch.launch.trainer.init_state`` on ``make_debug_mesh(m)``, its
parameters overwritten with the benchmark's weights; the traffic's ring
of batches; and the first ``check_steps`` steps through the window of
``trainer.make_window_step(..., device_steps=1)``, the path
``launch/train.py`` runs.  Those steps warm up every shape the window
runs, and the program's readings for ``correct`` are taken from them:
each step's mean worker loss, the first step's aggregate as AdamW holds
it (its first moment over 1 - b1) and the parameters' change over the
steps.

The window: steps back to back for ``--seconds``, each ending in a
synchronise; ``train_tokens_per_s`` is every worker's tokens over every
step the window ran, over the whole window.  ``peak_mem_gib`` is the
allocator's peak over set-up and window.  Then the program's state is
freed and the plain reference runs the same first steps from the same
weights on the same batches.

The traced run splits its window: bare steps for half of it (the model
FLOP rate), two steps under the profiler with the program's own spans
and counters on (``repro_torch.trace``: idle share, launches, the
aggregation kernel's time, device time by span), then two steps with
synchronising spans around the aggregation, the attack, the kernel call
and the update.

The model's reference, its weights' shapes and its FLOP count come from
the cell's reference module (``cell.reference``), never from a module
named here.
"""
from __future__ import annotations

import contextlib
import gc
import math
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from chipbench import bench, generate, tracing, yardstick
from chipbench.kinds import port_config
from chipbench.reference import train as reference

GIB = 1 << 30


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict / list of tensors by "a/b/c" path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


class Program:
    """The port's objects for a cell: its config, parallel config, mesh,
    optimizer and attack, built from the configuration and traffic files."""

    def __init__(self, cell: bench.Cell, device: torch.device):
        from repro_torch.configs.base import ParallelConfig
        from repro_torch.core.attacks import AttackConfig
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.optim.optimizers import get_optimizer

        t = cell.traffic
        self.ref = cell.reference
        self.model = cell.config["port"]
        self.cfg = port_config(self.model)
        self.pcfg = ParallelConfig(agg_method=t["agg"]["method"],
                                   agg_beta=t["agg"].get("beta", 0.0),
                                   agg_strategy=t["agg"]["strategy"], **t["parallel"])
        self.mesh = mesh_lib.make_debug_mesh(t["workers"], device=device)
        o = t["optimizer"]
        self.opt = get_optimizer(o["name"], o["lr"], o["weight_decay"])
        atk = t.get("attack") or {}
        self.attack = (AttackConfig(name=atk["name"], alpha=atk["alpha"],
                                    shift=atk.get("shift", 1.0), num_classes=self.cfg.vocab)
                       if atk.get("name", "none") != "none" else None)
        self.device = device

    def window(self, opt=None):
        from repro_torch.launch import trainer
        return trainer.make_window_step(self.cfg, self.pcfg, self.mesh, opt or self.opt,
                                        self.attack, device_steps=1)

    def state(self, seed: int, opt=None) -> Dict[str, Any]:
        """The trainer's fresh state, its parameters the benchmark's weights
        of ``seed`` (the leaves' paths and shapes must be the reference's)."""
        from repro_torch.launch import trainer
        state = trainer.init_state(self.cfg, self.mesh, opt or self.opt, seed=seed,
                                   pcfg=self.pcfg)
        flat = flatten(state["params"])
        specs = self.ref.param_specs(self.model)
        got = {p: tuple(t.shape) for p, t in flat.items()}
        want = {p: shape for p, (shape, _) in specs.items()}
        if got != want:
            raise bench.CellError(f"the port's parameter tree {got} is not the reference's {want}")
        weights = initial_weights(self.ref, self.model, seed, self.device)
        with torch.no_grad():
            for p, t in flat.items():
                t.copy_(weights(p))
        return state


def initial_weights(ref, model: Dict, seed: int, device) -> Callable[[str], torch.Tensor]:
    """``weights(path)``: the leaf ``path`` of the benchmark's weights of
    ``seed``, the shapes the reference module ``ref``'s."""
    return lambda p: generate.make_leaf(ref, model, seed, p, device)


def first_moment_norms(state: Dict[str, Any], b1: float) -> Dict[str, float]:
    """Each leaf's norm of the aggregate AdamW took at its first step: its
    first moment over 1 - b1.  Nothing of the state is kept."""
    opt_state = state["opt_state"]
    if not isinstance(opt_state, dict) or "m" not in opt_state:
        raise bench.CellError("the optimizer state has no first moment 'm'")
    return {p: float(t.float().norm()) / (1.0 - b1) for p, t in flatten(opt_state["m"]).items()}


def first_steps(window: Callable, state: Dict[str, Any], blocks: List[Dict], n: int,
                weights: Callable[[str], torch.Tensor], b1: float) -> Dict[str, Any]:
    """Run the first ``n`` steps and read them: each step's mean loss, the
    first step's aggregate as AdamW's first moment holds it, the change of
    each parameter leaf over the steps from ``weights(path)``."""
    losses, agg1 = [], {}
    before = float(state["metrics"]["loss_sum"])
    for i in range(n):
        state = window(state, blocks[i])
        after = float(state["metrics"]["loss_sum"])
        losses.append(after - before)
        before = after
        if i == 0:
            agg1 = first_moment_norms(state, b1)
    with torch.no_grad():
        delta = {p: float((t.float() - weights(p).float()).norm())
                 for p, t in flatten(state["params"]).items()}
    return {"losses": losses, "agg1": agg1, "delta": delta, "state": state}


def reference_readings(cell: bench.Cell, seed: int, ring: List[Dict], n: int, device,
                       mm: Optional[Callable] = None) -> Dict:
    """The cell's reference module over the first ``n`` steps of ``ring``
    from the weights of ``seed``, its products ``mm`` (the module's
    ``matmul`` by default; the control passes its ``fp8_matmul``)."""
    ref, model = cell.reference, cell.config["port"]
    return reference.run(ref, model, cell.traffic, initial_weights(ref, model, seed, device),
                         ring[:n], n, mm)


def judge(gaps: Dict[str, float], limits: Optional[Dict[str, float]],
          name: str) -> Dict[str, Dict[str, float]]:
    """Each number compared beside its limit (the numbers the limits file
    names; a number it leaves out is not compared)."""
    if not limits:
        raise bench.CellError(f"cell {name} has no limits file")
    return {k: {"value": gaps[k], "limit": float(v)} for k, v in limits.items()}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Trace:
    """What the per-layer metric readers read (``metrics/<name>.py``)."""

    def __init__(self, device: torch.device, work: Dict[str, float]):
        self.device_type = device.type
        self.work = work  # model_flops_per_step, agg_bytes_per_step, the peaks
        self.bare: Dict[str, float] = {}  # steps, wall_s of the bare stretch
        self.profile: Dict[str, Any] = {}  # tracing.profile's summary, steps, counts
        self.spans: Dict[str, List[float]] = {}  # ms a step by span name


def program_tracing():
    """(a context with the program's spans and counters on, the counters'
    ``take_counts``); a null context and no counts where the program has
    no ``repro_torch.trace``."""
    try:
        from repro_torch import trace
    except ImportError:
        return contextlib.nullcontext(), dict
    return trace.enabled(), trace.take_counts


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, limits: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    t = cell.traffic
    model = cell.config["port"]
    n_check = t["check_steps"]
    prog = Program(cell, device)
    spans = tracing.Spans(device) if trace else None  # looks every span's name up
    opt = prog.opt
    if spans is not None:
        from repro_torch.optim.optimizers import Optimizer
        opt = Optimizer(prog.opt.init, spans.wrap("update", prog.opt.update))
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    state = prog.state(seed, opt)
    ring = generate.make_ring(t, model["vocab"], seed, device)
    blocks = [{k: v[None] for k, v in b.items()} for b in ring]
    window = prog.window(opt)
    got = first_steps(window, state, blocks, n_check,
                      initial_weights(cell.reference, model, seed, device), t["optimizer"]["b1"])
    state = got.pop("state")
    tracing.sync(device)
    setup_s = time.perf_counter() - t_start

    tokens_per_step = t["workers"] * t["batch_per_worker"] * t["seq_len"]
    step_no = [n_check]

    def one_step():
        nonlocal state
        state = window(state, blocks[step_no[0] % len(blocks)])
        step_no[0] += 1

    def steps_for(limit_s: float) -> tuple:
        t0, n = time.perf_counter(), 0
        while True:
            one_step()
            tracing.sync(device)
            n += 1
            if time.perf_counter() - t0 >= limit_s:
                return n, time.perf_counter() - t0

    tr = None
    if not trace:
        n_win, window_s = steps_for(seconds)
    else:
        tr = Trace(device, {"model_flops_per_step": cell.reference.model_flops_per_step(model, t),
                            "agg_bytes_per_step": yardstick.aggregate_bytes_per_step(
                                cell.reference, model, t),
                            "peak_flops": yardstick.PEAK_BF16_FLOPS,
                            "hbm_bytes_per_s": yardstick.HBM_BYTES_PER_S})
        n_bare, bare_s = steps_for(seconds / 2)
        tr.bare = {"steps": n_bare, "wall_s": bare_s}
        prof_steps = 2
        traced, take_counts = program_tracing()
        with traced:
            tr.profile = tracing.profile(lambda: [one_step() for _ in range(prof_steps)], device)
        tr.profile["counts"] = take_counts()
        tr.profile["steps"] = prof_steps
        gc.collect()  # the profile's garbage, which would stall the spanned steps' host
        with spans.patched():
            for _ in range(2):
                spans.step(one_step)
        tr.spans = dict(spans.ms)
        n_win = n_bare + prof_steps + 2
    tracing.sync(device)
    loss_sum = float(state["metrics"]["loss_sum"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the program's state freed before the reference runs
    del state, window, opt, prog, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, ring, n_check, device)
    checks = judge(reference.gaps(got, ref),
                   limits if limits is not None else cell.limits.get("limits"), cell.name)
    finite = math.isfinite(loss_sum)
    correct = finite and all(c["value"] <= c["limit"] for c in checks.values())

    dev_info: Dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev_info["power"] = power_limit()
    breakdown = None
    if not trace:
        values = {"train_tokens_per_s": n_win * tokens_per_step / window_s,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise bench.CellError(f"a training cell has no end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        metrics = bench.read_per_layer(cell, tr)
        dev_info["busy_s"] = tr.profile["busy_s"]
        dev_info["window_s"] = tr.profile["window_s"]
        breakdown = {k: tr.profile[k][:10] for k in ("device_ops", "idle_gaps", "spans",
                                                     "idle_spans")}
        print(f"spans (name, calls, self s, subtree s, backward s) of {tr.profile['steps']} "
              f"profiled steps, busy {tr.profile['busy_s']!r} s: {tr.profile['spans']}",
              file=sys.stderr)
    return {"correct": correct, "attempted": n_win, "failed": 0 if finite else n_win,
            "metrics": metrics, "device": dev_info, "checks": checks,
            "breakdown": breakdown, "readings": {"program": got, "reference": ref},
            "trace": tr}
