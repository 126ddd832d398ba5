#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py   # needs one CUDA card and nvcc

Phases (any failure exits non-zero before the final line):
1. the card, torch/CUDA versions, TF32 off, the kernels' build from
   ``src/repro_torch/kernels/csrc/robust_agg.cu`` and ``histogram_agg.cu``
   (one nvcc per source, started together) with their ptxas reports;
2. every order-statistic kernel against its plain PyTorch version on the
   card, bitwise (NaN matched by position, -0 != +0): m in {2,...,64}, f32
   and bf16, ragged n and the main path's leaf sizes, columns with ±1e30,
   NaN and mixed ±0, every legal trim for m in {10, 17, 40};
2b. the sketch kernels (min/max, histogram) against their plain versions,
   bitwise (counts and sums): rows in {1, 7, 33, 256, 512, 1000}, n in {1,
   32, 33, 4097, 50176}, nbins in {2, 64, 256, 512, 4096}, f32 and bf16,
   with and without sums, columns with ±1e30 rows, a NaN, mixed ±0 and a
   constant; a row slice x[1:] (pointer not 16-byte aligned, n = 33), a
   wide view one element off, and 2^15 / 2^16 bins (past the shared-memory
   budget).  Every kernel variant (scalar and 16-byte loads; shared and
   global histogram) must have run;
2c. approx_median and approx_trimmed_mean on the card twice: bitwise equal,
   and within the CPU tests' tolerance of the CPU result;
3. the quickstart configuration (examples/quickstart.py): median and
   trimmed mean ROBUST (||w - w*|| < 0.2), mean BROKEN;
4. the main path: Algorithm 1 on the paper's CNN at full width (53,370
   parameters in 8 leaves), the Table 3 layout (m=10, n=400 per worker,
   sign_flip alpha=0.1 scale 20), median and trimmed mean (beta=0.1) for
   30 iterations each.  The launch counters are zeroed just before and
   read just after: every aggregation must have gone through a kernel.
   Algorithm 1 does not run the fused kernel, so its entry point
   (ops.fused_median_trimmed) is then called directly on the final
   per-worker gradients, and its count is that call's.  The first 3
   iterates are compared with the same run on the CPU; linreg runs at
   the Table 2 worker count (m=40);
5. times at the main path's shapes and one bandwidth-sized shape (CUDA
   events per call, and device time from torch.profiler), against the
   memory bound (3.35 TB/s) and the f32 operation bound (67 TFLOP/s) of
   an H100 SXM at 700 W, the plain version, and the one PyTorch call that
   computes the same function where there is one (the median's); the
   steady-state CNN step time, and the top device-time rows of a
   torch.profiler trace of 3 steps; the sketch kernels at the federated
   chunk (512 x 32, 512 bins), the CLI default (256 x 64, 256 bins) and a
   bandwidth shape (256 x 2^20, 128 bins, f32 and bf16), against the
   memory bound, their plain versions and torch.aminmax (min/max, timed in
   turns with the kernel; its device time too), with a line per min/max
   shape comparing them;
6. the federated path: ``fed.rounds.run_rounds`` at benchmarks/fed_scale.py's
   configuration (200,000 clients, cohorts of 100,000 in chunks of 512,
   d=32, n=16, 512 bins, sign_flip alpha=0.1 scale 100, beta=0.15, lr 0.3,
   sgd, 30 rounds) for approx_median, approx_trimmed_mean and stream_mean.
   The launch counters are zeroed before each method and read after it:
   196 min/max and 196 histogram launches per round for the robust
   methods, none for the mean.  Robust ||w - w*|| < 0.5, the mean's more
   than 10x the median's; the sketch median within one bin of the exact
   median of an attacked 10^4 cohort; the first 2 rounds agree with the
   CPU; the CLI runs twice with one sha256; a profile of one round (with
   the sketch kernels' device ms in it).
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores

SWEEP_M = (2, 3, 5, 8, 10, 16, 17, 32, 40, 64)
SWEEP_N = (1, 1000, 4097)
TRIM_SWEEP_M = (10, 17, 40)
CNN_LEAVES = 8
CNN_ITERS = 30


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- helpers


def adversarial_rows(m: int, n: int, seed: int):
    """N(0,1) rows with adversarial columns: ±1e30 rows, a NaN, mixed ±0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    if n >= 4:
        x[: max(1, m // 4), 0] = 1e30
        x[: max(1, m // 4), 1] = -1e30
        x[m // 2, 2] = np.nan
        x[:, 3] = np.where(rng.random(m) < 0.5, -0.0, 0.0)
    return x


def compare(got, want):
    """(bit mismatches, max |got - want|): NaN matches NaN, -0 != +0."""
    import torch

    g, w = got.float(), want.float()
    gn, wn = torch.isnan(g), torch.isnan(w)
    ok = torch.where(gn | wn, gn & wn, g.view(torch.int32) == w.view(torch.int32))
    diff = torch.where(gn | wn, torch.where(gn & wn, 0.0, float("inf")), (g - w).abs())
    return int((~ok).sum()), float(diff.max()) if diff.numel() else 0.0


def time_ms(fn, reps: int) -> float:
    """Mean time per call over ``reps`` calls, CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(a, b, reps: int):
    """Mean times per call of ``a`` and ``b`` (time_ms), taken in turns a, b,
    b, a, so that drift on the host touches both alike."""
    ta, tb = time_ms(a, reps), time_ms(b, reps)
    tb, ta = (tb + time_ms(b, reps)) / 2, (ta + time_ms(a, reps)) / 2
    return ta, tb


def device_ms(fn, reps: int, name: str = ""):
    """Device time per call of the kernels whose name contains ``name``
    (every kernel for ""), from torch.profiler (None when two traces show
    no such kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back without the kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and name in e.key)
        if us:
            return us / 1e3 / reps
    return None


# ------------------------------------------------------------------ phases


def kernel_sweep(dev, leaf_sizes):
    """Phase 2: each kernel vs its plain version, bitwise.  Returns the
    max |err| per kernel."""
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import selection_network as SN

    worst = {"median": 0.0, "trimmed_mean": 0.0, "fused_median_trimmed": 0.0}
    checked = 0

    def run(name, x, trim):
        nonlocal checked
        if name == "median":
            pairs = [(robust_agg.median(x), SN.median_select(x))]
        elif name == "trimmed_mean":
            pairs = [(robust_agg.trimmed_mean(x, trim), SN.trimmed_mean_select(x, trim))]
        else:
            pairs = list(zip(robust_agg.fused_median_trimmed(x, trim),
                             SN.median_and_trimmed_select(x, trim)))
        torch.cuda.synchronize()
        for got, want in pairs:
            bad, err = compare(got, want)
            check(bad == 0, f"{name} m={x.shape[0]} n={x.shape[1]} {x.dtype} trim={trim}: "
                            f"{bad} mismatches vs the plain version (max |err| {err})")
            worst[name] = max(worst[name], err)
            checked += 1

    for dtype in (torch.float32, torch.bfloat16):
        for m in SWEEP_M:
            trim = max(1, m // 10) if m >= 3 else 0
            for n in sorted(set(SWEEP_N) | set(leaf_sizes)):  # ragged n, the CNN's leaves
                x = torch.from_numpy(adversarial_rows(m, n, seed=m * 7919 + n)).to(dev, dtype)
                for name in worst:
                    run(name, x, trim)
        for m in TRIM_SWEEP_M:
            for n in (4097, max(leaf_sizes)):
                x = torch.from_numpy(adversarial_rows(m, n, seed=m + n)).to(dev, dtype)
                for trim in range(0, (m + 1) // 2):
                    run("trimmed_mean", x, trim)
                    run("fused_median_trimmed", x, trim)
    print(f"phase 2: {checked} kernel outputs bitwise equal to the plain version "
          f"(max |err| {json.dumps(worst)})")
    return worst


def quickstart(dev):
    """Phase 3: examples/quickstart.py on the port."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import RobustGDConfig, run_linreg_experiment

    attack = AttackConfig("sign_flip", alpha=0.25, scale=10.0)
    errs = {}
    for method in ("mean", "median", "trimmed_mean"):
        cfg = RobustGDConfig(method=method, beta=0.3, step_size=0.5, num_iters=100)
        err, _ = run_linreg_experiment(0, d=20, n=500, m=8, sigma=0.5, cfg=cfg,
                                       attack=attack, device=dev)
        errs[method] = float(err)
        status = "ROBUST" if errs[method] < 0.2 else "BROKEN"
        print(f"phase 3: {method:13s} ||w - w*|| = {errs[method]:8.4f}   [{status}]")
    check(errs["median"] < 0.2 and errs["trimmed_mean"] < 0.2,
          f"quickstart: a robust aggregator is BROKEN: {errs}")
    check(not errs["mean"] < 0.2, f"quickstart: mean is not BROKEN: {errs}")


def cnn_setup(dev):
    import torch

    from repro_torch.data.pipeline import DataConfig, make_classification_shards
    from repro_torch.models.paper_models import init_cnn

    m, n = 10, 400  # benchmarks/table3_cnn.py
    shards = make_classification_shards(DataConfig(global_batch=m * n, num_workers=m),
                                        device=dev)
    params = init_cnn(torch.Generator().manual_seed(0), device=dev)
    return shards, params


CNN_ATTACK = dict(name="sign_flip", alpha=0.1, scale=20.0)


def cnn_config(method, iters):
    from repro_torch.core.robust_gd import RobustGDConfig

    return RobustGDConfig(method=method, beta=0.1, step_size=0.05, num_iters=iters)


def main_path(dev):
    """Phase 4: Algorithm 1 on the CNN; returns the launch counts."""
    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import make_robust_gd_stages, robust_gd
    from repro_torch.kernels import ops, robust_agg
    from repro_torch.models.paper_models import cnn_loss

    shards, params = cnn_setup(dev)
    check(sum(p.numel() for p in params.values()) == 53370 and len(params) == CNN_LEAVES,
          "the CNN is not the paper's width-16 network")
    pooled = {"x": shards["x"].reshape(-1, 784), "y": shards["y"].reshape(-1)}
    loss0 = float(cnn_loss(params, pooled))
    attack = AttackConfig(**CNN_ATTACK)
    torch.cuda.synchronize()

    robust_agg.reset_launches()  # zeroed just before robust_gd's runs
    finals = {}
    for method in ("median", "trimmed_mean"):
        t0 = time.perf_counter()
        w, _ = robust_gd(cnn_loss, params, shards, cnn_config(method, CNN_ITERS), attack)
        torch.cuda.synchronize()
        loss = float(cnn_loss(w, pooled))
        print(f"phase 4: cnn {method:13s} loss {loss0:.4f} -> {loss:.4f} after "
              f"{CNN_ITERS} iterations ({time.perf_counter() - t0:.2f} s, first call included)")
        check(loss == loss and abs(loss) != float("inf"), f"cnn {method}: loss not finite")
        check(loss < loss0, f"cnn {method}: loss did not fall ({loss0} -> {loss})")
        finals[method] = w
    launches = dict(robust_agg.LAUNCHES)  # read just after robust_gd's runs
    print(f"phase 4: launches on robust_gd's path: median {launches['median']}, "
          f"trimmed_mean {launches['trimmed_mean']}")
    check(launches["median"] == CNN_ITERS * CNN_LEAVES,
          f"median kernel launched {launches['median']} times, want {CNN_ITERS * CNN_LEAVES}")
    check(launches["trimmed_mean"] == CNN_ITERS * CNN_LEAVES,
          f"trimmed-mean kernel launched {launches['trimmed_mean']} times")
    check(launches["fused_median_trimmed"] == 0, "robust_gd launched the fused kernel")
    # Algorithm 1 never runs the fused kernel: call its entry point on the
    # ops surface directly, on the final per-worker gradients
    stages = make_robust_gd_stages(cnn_loss, shards, cnn_config("median", 1), attack)
    grads = stages.attack(stages.local_work(finals["median"], CNN_ITERS),
                          {k: torch.zeros_like(v) for k, v in params.items()}, CNN_ITERS)
    fused = {k: ops.fused_median_trimmed(g, beta=0.1) for k, g in grads.items()}
    torch.cuda.synchronize()
    launches["fused_median_trimmed"] = robust_agg.LAUNCHES["fused_median_trimmed"]
    print(f"phase 4: fused kernel: {launches['fused_median_trimmed']} launches, "
          f"ops.fused_median_trimmed called directly; not on robust_gd's path")
    check(launches["fused_median_trimmed"] == CNN_LEAVES,
          f"fused kernel launched {launches['fused_median_trimmed']} times")
    for k, g in grads.items():
        med, tm = fused[k]
        flat = g.reshape(g.shape[0], -1)
        check(compare(med, robust_agg.median(flat).reshape(med.shape))[0] == 0,
              f"fused median != median kernel on leaf {k}")
        trim = int(0.1 * flat.shape[0])
        check(compare(tm, robust_agg.trimmed_mean(flat, trim).reshape(tm.shape))[0] == 0,
              f"fused trimmed mean != trimmed-mean kernel on leaf {k}")
        check(bool(torch.isfinite(med).all() and torch.isfinite(tm).all()),
              f"non-finite aggregate on leaf {k}")
    return launches


def cpu_agreement(dev):
    """Phase 4b: the first 3 iterates on the card vs the same run on the CPU.
    Tolerance: 1e-4 of each leaf's scale (f32 convolution and reduction
    orders differ between cuDNN and the CPU; the median then selects among
    values that differ by the same few ulps)."""
    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import robust_gd
    from repro_torch.models.paper_models import cnn_loss

    shards, params = cnn_setup(dev)
    attack = AttackConfig(**CNN_ATTACK)
    keys = sorted(params)
    iterate = lambda w: torch.cat([w[k].reshape(-1) for k in keys])  # every leaf, flat
    to_cpu = lambda t: {k: v.cpu() for k, v in t.items()}
    for method in ("median", "trimmed_mean"):
        _, on_card = robust_gd(cnn_loss, params, shards, cnn_config(method, 3), attack,
                               trajectory_fn=iterate)
        _, on_cpu = robust_gd(cnn_loss, to_cpu(params), to_cpu(shards),
                              cnn_config(method, 3), attack, trajectory_fn=iterate)
        on_card = on_card.cpu()
        for it in range(3):
            worst, start = 0.0, 0
            for k in keys:
                size = params[k].numel()
                g = on_card[it, start:start + size]
                c = on_cpu[it, start:start + size]
                start += size
                rel = float((g - c).abs().max()) / max(float(c.abs().max()), 1e-12)
                worst = max(worst, rel)
                check(rel <= 1e-4, f"cnn {method} iterate {it + 1} leaf {k}: card vs CPU "
                                   f"differ by {rel:.3g} of the leaf scale")
            print(f"phase 4: cnn {method:13s} iterate {it + 1}: card vs CPU max diff "
                  f"{worst:.3g} of leaf scale")


def table2_linreg(dev):
    """Phase 4c: linreg at the paper's Table 2 worker count, m=40."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import RobustGDConfig, run_linreg_experiment
    from repro_torch.kernels import robust_agg

    attack = AttackConfig("sign_flip", alpha=0.05, scale=10.0)
    for method in ("median", "trimmed_mean"):
        before = dict(robust_agg.LAUNCHES)
        cfg = RobustGDConfig(method=method, beta=0.05, step_size=0.5, num_iters=100)
        err, _ = run_linreg_experiment(1, d=20, n=300, m=40, sigma=0.5, cfg=cfg,
                                       attack=attack, device=dev)
        ran = robust_agg.LAUNCHES[method] - before[method]
        print(f"phase 4: linreg m=40 {method:13s} ||w - w*|| = {float(err):.4f} "
              f"({ran} kernel launches)")
        check(float(err) < 0.2, f"linreg m=40 {method} is BROKEN")
        check(ran == 100, f"linreg m=40 {method}: {ran} launches, want 100")


def op_count(name: str, m: int, trim: int) -> int:
    """Operations per coordinate: 2 per comparator, plus the midpoint
    (even m) and the band's adds and division."""
    from repro_torch.kernels import selection_network as SN

    prog = {"median": lambda: SN.median_program(m),
            "trimmed_mean": lambda: SN.trimmed_program(m, trim),
            "fused_median_trimmed": lambda: SN.fused_program(m, trim)}[name]()
    ops = 2 * prog.size
    if name != "trimmed_mean" and m % 2 == 0:
        ops += 2
    if name != "median":
        ops += m - 2 * trim
    return ops


def bound(name: str, m: int, n: int, trim: int, elem: int):
    outs = 2 if name == "fused_median_trimmed" else 1
    mem_ms = (m * n + outs * n) * elem / MEM_BYTES_PER_S * 1e3
    ops_ms = op_count(name, m, trim) * n / F32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def library_call(name: str, x):
    """One PyTorch call that computes the same function, or None.  Only the
    median has one: torch.median for odd m (it returns the lower middle value
    for even m), and for even m torch.quantile's midpoint, which takes f32 of
    at most 2^24 elements.  No call computes the trimmed mean."""
    import torch

    if name != "median":
        return None
    if x.shape[0] % 2:
        return lambda: torch.median(x, dim=0).values
    if x.dtype == torch.float32 and x.numel() <= 1 << 24:
        return lambda: torch.quantile(x, 0.5, dim=0, interpolation="midpoint")
    return None


def timings(dev, card: str):
    """Phase 5: kernel / plain / library times; returns the rows."""
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import selection_network as SN

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [("cnn fc1 leaf", 10, 50176, f32), ("logreg w leaf", 40, 7840, f32),
              ("bandwidth", 32, 1 << 24, f32), ("bandwidth, odd m", 31, 1 << 24, f32),
              ("bandwidth", 32, 1 << 24, bf16)]
    rows = []
    for label, m, n, dtype in shapes:
        x = torch.randn(m, n, device=dev).to(dtype)
        trim = int(0.1 * m)
        big = n >= 1 << 20
        fns = {
            "median": (lambda: robust_agg.median(x), lambda: SN.median_select(x)),
            "trimmed_mean": (lambda: robust_agg.trimmed_mean(x, trim),
                             lambda: SN.trimmed_mean_select(x, trim)),
            "fused_median_trimmed": (lambda: robust_agg.fused_median_trimmed(x, trim),
                                     lambda: SN.median_and_trimmed_select(x, trim)),
        }
        for name, (kernel, plain) in fns.items():
            b_ms, b_by = bound(name, m, n, trim, x.element_size())
            lib = library_call(name, x)
            row = {"shape": label, "kernel": name, "m": m, "n": n, "trim": trim,
                   "dtype": str(dtype).removeprefix("torch."),
                   "ms": time_ms(kernel, 20 if big else 200),
                   "device_ms": device_ms(kernel, 20, "select_kernel"),
                   "plain_ms": time_ms(plain, 3 if big else 20),
                   "library_ms": time_ms(lib, 20 if big else 200) if lib else None,
                   # the library's answer against the kernel's, same inputs
                   "library_max_abs_diff": compare(lib(), kernel())[1] if lib else None,
                   "bound_ms": b_ms, "bound_by": b_by, "card": card}
            rows.append(row)
            print(json.dumps({"timing": row}))
        del x
        torch.cuda.empty_cache()
    return rows


def cnn_step_time(dev):
    """Steady-state time of one Algorithm 1 step on the CNN (host clock
    around 10 steps ending in a synchronize, after 3 warm-up steps), then
    the top device-time rows of a torch.profiler trace of 3 more steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import make_robust_gd_stages
    from repro_torch.models.paper_models import cnn_loss
    from repro_torch.rounds import engine

    shards, params = cnn_setup(dev)
    out = {}
    for method in ("median", "trimmed_mean"):
        stages = make_robust_gd_stages(cnn_loss, shards, cnn_config(method, 10),
                                       AttackConfig(**CNN_ATTACK))
        body = engine.make_round_body(stages)
        state = engine.make_state(params)
        for r in range(3):
            state, _ = body(state, r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(3, 13):
            state, _ = body(state, r)
        torch.cuda.synchronize()
        out[method] = (time.perf_counter() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for r in range(13, 16):
                state, _ = body(state, r)
            torch.cuda.synchronize()
        # kernels (CUDA events) sum to the device time; each op's self
        # device time is that of the kernels it launched itself
        events = prof.key_averages()
        total = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
        ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_device_time_total, reverse=True)[:12]
        print(json.dumps({"profile_3_steps": method, "device_ms": total / 1e3, "top_ops": [
            {"op": e.key[:60], "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
            for e in ops]}))
    print(json.dumps({"cnn_step_ms": out}))


# ------------------------------------------------------- the sketch kernels

SKETCH_ROWS = (1, 7, 33, 256, 512, 1000)
SKETCH_N = (1, 32, 33, 4097, 50176)
SKETCH_NBINS = (2, 64, 256, 512, 4096)
# past the shared-memory budget: 2^15 bins with sums and 2^16 bins take the
# global-memory histogram, 2^15 counts only a one-column tile
SKETCH_WIDE_NBINS = (1 << 15, 1 << 16)


def sketch_rows(rows: int, n: int, seed: int):
    """3 * N(0,1) rows with adversarial columns: ±1e30 rows, a NaN, mixed
    ±0 and a constant (zero-width) column."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((rows, n))).astype(np.float32)
    if n >= 4:
        x[: max(1, rows // 4), 0] = 1e30
        x[rows // 2:, 0] = -1e30
        x[rows // 2, 1] = np.nan
        x[:, 2] = np.where(rng.random(rows) < 0.5, -0.0, 0.0)
        x[:, 3] = 1.25
    return x


def sketch_sweep(dev):
    """Phase 2b: the min/max and histogram kernels vs their plain versions,
    bitwise.  Returns the max |err| per kernel."""
    import torch

    from repro_torch.kernels import histogram_agg as H

    worst = {"minmax": 0.0, "histogram": 0.0}
    checked = 0
    plans = set()

    def run(x, label, nbins_set):
        nonlocal checked
        plans.add(H.minmax_plan_for(x))
        lo, hi = H.minmax(x)
        plo, phi = H.minmax_plain(x)
        torch.cuda.synchronize()
        for got, want in ((lo, plo), (hi, phi)):
            bad, err = compare(got, want)
            check(bad == 0, f"minmax {label}: {bad} mismatches vs the plain version "
                            f"(max |err| {err})")
            worst["minmax"] = max(worst["minmax"], err)
            checked += 1
        for nbins in nbins_set:
            lo, width = H.edges(plo, phi, nbins)
            for with_sums in (True, False):
                plans.add(H.histogram_plan(x.shape[0], x.shape[1], nbins, with_sums))
                got = H.histogram(x, lo, width, nbins, with_sums)
                want = H.histogram_plain(x, lo, width, nbins, with_sums)
                torch.cuda.synchronize()
                for part, g, w in zip(("counts", "sums"), got, want):
                    if w is None:
                        check(g is None, "histogram wrote sums with with_sums=False")
                        continue
                    bad, err = compare(g, w)
                    check(bad == 0, f"histogram {part} {label} nbins={nbins} "
                                    f"sums={with_sums}: {bad} mismatches vs the plain "
                                    f"version (max |err| {err})")
                    worst["histogram"] = max(worst["histogram"], err)
                    checked += 1
                del got, want
            if x.shape[1] == 50176 and nbins == 4096:
                torch.cuda.empty_cache()

    for dtype in (torch.float32, torch.bfloat16):
        for rows in SKETCH_ROWS:
            for n in SKETCH_N:
                x = torch.from_numpy(sketch_rows(rows, n, seed=rows * 7 + n)).to(dev, dtype)
                run(x, f"rows={rows} n={n} {dtype}", SKETCH_NBINS)
        # views the chunked sketch passes: a row slice whose pointer is not
        # 16-byte aligned (n = 33), and a wide chunk one element off
        base = torch.from_numpy(sketch_rows(34, 33, seed=34)).to(dev, dtype)
        run(base[1:], f"row slice x[1:] rows=33 n=33 {dtype}", SKETCH_NBINS)
        view = torch.empty(33 * 50176 + 1, device=dev, dtype=dtype)[1:].view(33, 50176)
        view.copy_(torch.from_numpy(sketch_rows(33, 50176, seed=5)))
        check(view.data_ptr() % 16 != 0 and H.minmax_plan_for(view).vec == 1,
              "the misaligned wide view did not take scalar loads")
        run(view, f"misaligned view rows=33 n=50176 {dtype}", (2, 512))
        # past the shared-memory budget
        x = torch.from_numpy(sketch_rows(33, 33, seed=33)).to(dev, dtype)
        run(x, f"rows=33 n=33 {dtype}", SKETCH_WIDE_NBINS)
    variants = {"minmax vec": sorted({p.vec for p in plans if isinstance(p, H.MinmaxPlan)}),
                "histogram": sorted({"shared" if p.shared else "global" for p in plans
                                     if isinstance(p, H.HistogramPlan)})}
    check(variants == {"minmax vec": [1, 4, 8], "histogram": ["global", "shared"]},
          f"the sweep missed a kernel variant: {variants}")
    print(f"phase 2b: {checked} sketch-kernel outputs bitwise equal to the plain version "
          f"(max |err| {json.dumps(worst)}; variants {json.dumps(variants)})")
    return worst


def approx_repeatable(dev):
    """Phase 2c: the approx_* aggregators on the card (through the sketch
    kernels) twice on one input: bitwise equal, and within the CPU tests'
    tolerance (rtol = atol = 1e-5, tests/test_torch_aggregators.py) of the
    same call on the CPU."""
    import numpy as np
    import torch

    from repro_torch.core import aggregators as A

    rng = np.random.default_rng(4)
    cases = [rng.standard_normal((20, 6, 7)).astype(np.float32),
             rng.standard_normal((257, 4096)).astype(np.float32)]
    for x_np in cases:
        for name in ("approx_median", "approx_trimmed_mean"):
            agg = A.get_aggregator(name, 0.2)
            x = torch.from_numpy(x_np)
            first, second = agg(x.to(dev)), agg(x.to(dev))
            torch.cuda.synchronize()
            bad, _ = compare(first, second)
            check(bad == 0, f"{name} {x_np.shape}: two card calls differ in {bad} places")
            on_cpu, first = agg(x), first.cpu()
            diff = float((first - on_cpu).abs().max())
            check(torch.allclose(first, on_cpu, rtol=1e-5, atol=1e-5),
                  f"{name} {x_np.shape}: card vs CPU beyond rtol=atol=1e-5 (max |diff| {diff})")
            print(f"phase 2c: {name} {tuple(x_np.shape)}: two card calls bitwise equal; "
                  f"card vs CPU max |diff| {diff:.3g}")


def sketch_bound(name: str, rows: int, n: int, nbins: int, elem: int, sums: bool):
    """(ms, "bytes"|"operations"): the inputs read once and the outputs
    written once over the memory rate, against ~2 (min/max) or ~6 + k
    (histogram: sub, div, floor, clip, convert, k adds) f32 operations per
    element over the f32 rate."""
    k = 2 if sums else 1
    if name == "minmax":
        nbytes, ops = rows * n * elem + 2 * n * 4, 2 * rows * n
    else:
        nbytes, ops = rows * n * elem + 2 * n * 4 + k * nbins * n * 4, (6 + k) * rows * n
    mem_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


SKETCH_SHAPES = (("fed chunk", 512, 32, 512), ("cli default", 256, 64, 256),
                 ("bandwidth", 256, 1 << 20, 128))


def sketch_timings(dev, card: str):
    """Phase 5b: min/max and histogram kernel / plain / library times."""
    import torch

    from repro_torch.kernels import histogram_agg as H

    rows_out = []
    cases = [(label, r, n, nb, torch.float32) for label, r, n, nb in SKETCH_SHAPES]
    cases.append(("bandwidth", 256, 1 << 20, 128, torch.bfloat16))
    for label, rows, n, nbins, dtype in cases:
        x = (3 * torch.randn(rows, n, device=dev)).to(dtype)
        lo, hi = H.minmax(x)
        lo, width = H.edges(lo, hi, nbins)
        big = n >= 1 << 20
        fns = {
            ("minmax", False): (lambda: H.minmax(x), lambda: H.minmax_plain(x),
                                lambda: torch.aminmax(x.float(), dim=0), "minmax_kernel"),
            ("histogram", True): (lambda: H.histogram(x, lo, width, nbins, True),
                                  lambda: H.histogram_plain(x, lo, width, nbins, True),
                                  None, "histogram_kernel"),
            ("histogram", False): (lambda: H.histogram(x, lo, width, nbins, False),
                                   lambda: H.histogram_plain(x, lo, width, nbins, False),
                                   None, "histogram_kernel"),
        }
        for (name, sums), (kernel, plain, lib, kname) in fns.items():
            b_ms, b_by = sketch_bound(name, rows, n, nbins, x.element_size(), sums)
            reps = 20 if big else 200
            ms, lib_ms = time_pair(kernel, lib, reps) if lib else (time_ms(kernel, reps), None)
            row = {"shape": label, "kernel": name, "rows": rows, "n": n, "nbins": nbins,
                   "with_sums": sums, "dtype": str(dtype).removeprefix("torch."),
                   "ms": ms, "device_ms": device_ms(kernel, 20, kname),
                   "plain_ms": time_ms(plain, 2 if big else 10),
                   "library_ms": lib_ms,
                   "library_device_ms": device_ms(lib, 20) if lib else None,
                   "bound_ms": b_ms, "bound_by": b_by, "card": card}
            rows_out.append(row)
            print(json.dumps({"timing": row}))
        del x
        torch.cuda.empty_cache()
    for r in rows_out:
        if r["kernel"] == "minmax":
            print(f"phase 5b: minmax {r['shape']} {r['rows']} x {r['n']} {r['dtype']}: "
                  f"per call kernel {r['ms']:.5f} ms vs torch.aminmax {r['library_ms']:.5f} ms "
                  f"({r['library_ms'] / r['ms']:.2f}x); device {r['device_ms']:.5f} vs "
                  f"{r['library_device_ms']:.5f} ms "
                  f"({r['library_device_ms'] / r['device_ms']:.2f}x); bound {r['bound_ms']:.5f} ms")
    return rows_out


# --------------------------------------------------------- the federated path

FED_POP = dict(num_clients=200_000, samples_per_client=16, dim=32, alpha=0.1, seed=0)
FED_ROUNDS = dict(cohort_size=100_000, chunk_clients=512, beta=0.15, nbins=512, lr=0.3,
                  optimizer="sgd", seed=0)
FED_NUM_ROUNDS = 30
FED_METHODS = ("approx_median", "approx_trimmed_mean", "stream_mean")


def fed_attack():
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.fed.rounds import AttackMixture

    return AttackMixture((AttackConfig("sign_flip", alpha=0.1, scale=100.0),))


def fed_path(dev):
    """Phase 6: fed.rounds.run_rounds at fed_scale's configuration; returns
    the launch counts summed over the three methods' runs."""
    import math

    import torch

    from repro_torch.fed.population import ClientPopulation, PopulationConfig
    from repro_torch.fed.rounds import RoundConfig, run_rounds
    from repro_torch.kernels import histogram_agg as H

    pop = ClientPopulation(PopulationConfig(**FED_POP), device=dev)
    chunks = math.ceil(FED_ROUNDS["cohort_size"] / FED_ROUNDS["chunk_clients"])
    total = {"minmax": 0, "histogram": 0}
    errs = {}
    for method in FED_METHODS:
        rcfg = RoundConfig(num_rounds=FED_NUM_ROUNDS, method=method, **FED_ROUNDS)
        torch.cuda.synchronize()
        H.reset_launches()  # zeroed just before this method's run
        t0 = time.perf_counter()
        w, hist = run_rounds(pop, rcfg, fed_attack())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(H.LAUNCHES)  # read just after it
        errs[method] = hist[-1]["err"]
        print(json.dumps({"fed_run": method, "rounds": FED_NUM_ROUNDS,
                          "rounds_per_s": FED_NUM_ROUNDS / dt, "seconds": dt,
                          "err_first": hist[0]["err"], "err_final": errs[method],
                          "launches": launches}))
        check(all(math.isfinite(h["err"]) for h in hist) or method == "stream_mean",
              f"fed {method}: non-finite err")
        want = 0 if method == "stream_mean" else chunks * FED_NUM_ROUNDS
        for k in total:
            check(launches[k] == want, f"fed {method}: {launches[k]} {k} launches, want {want} "
                                       f"({chunks} per round)")
            total[k] += launches[k]
    print(f"phase 6: ||w - w*|| after {FED_NUM_ROUNDS} rounds: "
          + ", ".join(f"{m} {errs[m]:.4f}" for m in FED_METHODS))
    for m in ("approx_median", "approx_trimmed_mean"):
        check(errs[m] < 0.5, f"fed {m} is BROKEN: ||w - w*|| = {errs[m]}")
    check(not errs["stream_mean"] <= 10 * errs["approx_median"],
          f"fed stream_mean is not 10x worse than the median: {errs}")
    return pop, total


def fed_sketch_vs_exact(pop):
    """Phase 6: the sketch median of one attacked 10^4-client cohort vs the
    exact median of the same rows on the card (torch.median gives the
    lower middle value of the even cohort, kthvalue the upper; their
    midpoint is np.median's convention, as fed_scale.py uses)."""
    import torch

    from repro_torch.fed.rounds import (RoundConfig, _chunk_bounds, _make_chunk_fn,
                                        aggregate_cohort)

    m = 10_000
    rcfg = RoundConfig(**dict(FED_ROUNDS, cohort_size=m), method="approx_median")
    atk = fed_attack().for_round(0)
    w = torch.zeros(pop.cfg.dim, device=pop.device)
    ids = pop.sample_cohort(FED_ROUNDS["seed"] + 1, 0, m)
    got = aggregate_cohort(pop, w, ids, rcfg, atk)
    bounds = _chunk_bounds(m, rcfg.chunk_clients)
    fn = _make_chunk_fn(pop, w, ids, bounds, atk)
    full = torch.cat([fn(j) for j in range(len(bounds))])
    lower = torch.median(full, dim=0).values
    upper = torch.kthvalue(full, m // 2 + 1, dim=0).values
    exact = (lower + upper) * 0.5
    width = (full.amax(0) - full.amin(0)) / rcfg.nbins
    dev_ = (got - exact).abs()
    ok = bool((dev_ <= width * 1.0001 + 1e-6).all())
    print(f"phase 6: 10^4 cohort: sketch median vs exact: max dev {float(dev_.max()):.4g}, "
          f"max bin width {float(width.max()):.4g}, within one bin: {ok}")
    check(ok, "the sketch median is more than one bin width from the exact median")


def fed_cpu_agreement(dev):
    """Phase 6: the first 2 rounds on the card vs the same run on the CPU at
    a cohort of 4,096.  The data draws are the same integers on both; float
    sums and products differ by a few ulps, and a row near a bin edge may
    change bins.  So the round-0 aggregate is held to one bin width per
    coordinate and each round's ||w - w*|| to 1e-4 (the CPU tests' bound
    against the reference)."""
    import torch

    from repro_torch.fed.population import ClientPopulation, PopulationConfig
    from repro_torch.fed.rounds import (RoundConfig, _chunk_bounds, _make_chunk_fn,
                                        aggregate_cohort, run_rounds)

    cohort = 4096
    pops = {d: ClientPopulation(PopulationConfig(**FED_POP), device=d) for d in (dev, "cpu")}
    ids = pops["cpu"].sample_cohort(0, 0, cohort)
    x_card = pops[dev].client_batch(ids.to(dev))[0].cpu()
    x_cpu = pops["cpu"].client_batch(ids)[0]
    print(f"phase 6: client data card vs CPU: max |diff| "
          f"{float((x_card - x_cpu).abs().max()):.3g}")
    atk = fed_attack().for_round(0)
    w0 = torch.zeros(FED_POP["dim"])
    fn = _make_chunk_fn(pops["cpu"], w0, ids, _chunk_bounds(cohort, 512), atk)
    full = torch.cat([fn(j) for j in range(cohort // 512)])
    width = (full.amax(0) - full.amin(0)) / FED_ROUNDS["nbins"]
    for method in ("approx_median", "approx_trimmed_mean"):
        rcfg = RoundConfig(num_rounds=2, method=method, **dict(FED_ROUNDS, cohort_size=cohort))
        g = {d: aggregate_cohort(p, w0.to(p.device), ids.to(p.device), rcfg, atk).cpu()
             for d, p in pops.items()}
        hists = {d: run_rounds(p, rcfg, fed_attack())[1] for d, p in pops.items()}
        diff = (g[dev] - g["cpu"]).abs()
        rows = [(a["err"], b["err"]) for a, b in zip(hists[dev], hists["cpu"])]
        print(f"phase 6: {method}: round-0 aggregate card vs CPU max |diff| "
              f"{float(diff.max()):.3g}; ||w - w*|| card/CPU per round {rows}")
        check(all(abs(a - b) <= 1e-4 for a, b in rows),
              f"fed {method}: card and CPU trajectories differ: {rows}")
        check(bool((diff <= width * 1.0001 + 1e-6).all()),
              f"fed {method}: round-0 aggregates differ by more than one bin width")


def fed_cli(dev):
    """Phase 6: python -m repro_torch.fed.run twice on the card: exit 0 and
    one sha256."""
    import os

    args = [sys.executable, "-m", "repro_torch.fed.run", "--clients", "20000", "--cohort",
            "4096", "--chunk", "512", "--rounds", "3", "--dim", "32", "--samples-per-client",
            "16", "--alpha", "0.1", "--nbins", "512", "--beta", "0.15", "--lr", "0.3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    digests = []
    for _ in range(2):
        out = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300,
                             cwd=ROOT)
        check(out.returncode == 0, f"fed CLI exited {out.returncode}: {out.stderr[-2000:]}")
        line = [ln for ln in out.stdout.splitlines() if "final iterate sha256" in ln]
        check(len(line) == 1, f"fed CLI printed no sha256 line: {out.stdout[-2000:]}")
        check("device=cuda" in out.stdout, "fed CLI did not run on the card")
        digests.append(line[0].split("=")[-1].strip())
    print(f"phase 6: CLI twice on the card: sha256 {digests[0]} / {digests[1]}")
    check(digests[0] == digests[1], "the fed CLI is not deterministic on the card")


def fed_profile(pop):
    """Phase 6: a torch.profiler trace of one approx_median round at the
    full cohort: the device's busy time, as a share of the same round's
    unprofiled host-clock time, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fed.rounds import RoundConfig, run_rounds

    rcfg = RoundConfig(num_rounds=1, method="approx_median", **FED_ROUNDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_rounds(pop, rcfg, fed_attack())  # unprofiled
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_rounds(pop, rcfg, fed_attack())
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    sketch = {name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
              for name in ("minmax_kernel", "histogram_kernel")}
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_device_time_total, reverse=True)[:15]
    print(json.dumps({"profile_fed_round": "approx_median", "round_ms": wall_ms,
                      "round_ms_profiled": profiled_ms, "device_busy_ms": busy_ms,
                      "device_busy_share": busy_ms / wall_ms if wall_ms else None,
                      "sketch_kernels_device_ms": sketch,
                      "top_kernels": [{"kernel": e.key[:70], "device_ms":
                                       e.self_device_time_total / 1e3, "calls": e.count}
                                      for e in kernels[:15]],
                      "top_ops": [{"op": e.key[:60], "device_ms": e.self_device_time_total / 1e3,
                                   "calls": e.count} for e in ops]}))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script drives the CUDA port")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import robust_agg

    dev = torch.device("cuda", 0)
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import histogram_agg

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        libs = list(pool.map(lambda mod: mod.build(), (robust_agg, histogram_agg)))
    robust_agg.load()
    histogram_agg.load()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(lib.name for lib in libs)})")
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"  ptxas ({lib.name.split('-')[0]}):", line.strip())

    leaf_sizes = (144, 16, 2304, 16, 50176, 64, 640, 10)  # the CNN's 8 leaves
    t0 = time.perf_counter()
    worst = kernel_sweep(dev, leaf_sizes)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worst.update(sketch_sweep(dev))
    print(f"phase 2b: {time.perf_counter() - t0:.1f} s")
    approx_repeatable(dev)
    quickstart(dev)
    launches = main_path(dev)
    cpu_agreement(dev)
    table2_linreg(dev)
    rows = timings(dev, card)
    sketch_rows_ = sketch_timings(dev, card)
    cnn_step_time(dev)
    t0 = time.perf_counter()
    pop, fed_launches = fed_path(dev)
    launches.update(fed_launches)
    fed_sketch_vs_exact(pop)
    fed_cpu_agreement(dev)
    fed_cli(dev)
    fed_profile(pop)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # the TPU kernels replaced: median_pallas, trimmed_mean_pallas and
    # fused_median_trimmed_pallas
    lines = {"median": 76, "trimmed_mean": 101, "fused_median_trimmed": 126}
    kernels = []
    for name in lines:
        row = next(r for r in rows if r["kernel"] == name and r["shape"] == "cnn fc1 leaf")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/robust_agg.cu",
            "replaces": f"src/repro/kernels/robust_agg.py:{lines[name]}",
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # minmax_pallas and histogram_pallas, timed at the federated chunk
    # (histogram with sums, as approx_trimmed_mean runs it)
    for name, line in (("minmax", 206), ("histogram", 254)):
        row = next(r for r in sketch_rows_ if r["kernel"] == name and r["shape"] == "fed chunk"
                   and r["with_sums"] == (name == "histogram"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/histogram_agg.cu",
            "replaces": f"src/repro/kernels/histogram_agg.py:{line}",
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
