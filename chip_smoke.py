#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py   # needs one CUDA card and nvcc

Phases (any failure exits non-zero before the final line):
1. the card, torch/CUDA versions, TF32 off, the kernels' build from
   ``src/repro_torch/kernels/csrc/robust_agg.cu``;
2. every kernel against its plain PyTorch version on the card, bitwise
   (NaN matched by position, -0 != +0): m in {2,...,64}, f32 and bf16,
   ragged n and the main path's leaf sizes, columns with ±1e30, NaN and
   mixed ±0, every legal trim for m in {10, 17, 40};
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
   torch.profiler trace of 3 steps.
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


def device_ms(fn, reps: int, name: str):
    """Device time per call of the kernels whose name contains ``name``,
    from torch.profiler (None when the trace shows no such kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if name in e.key)
    return us / 1e3 / reps if us else None


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
    t0 = time.perf_counter()
    lib = robust_agg.build()
    robust_agg.load()
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s ({lib.name})")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    leaf_sizes = (144, 16, 2304, 16, 50176, 64, 640, 10)  # the CNN's 8 leaves
    t0 = time.perf_counter()
    worst = kernel_sweep(dev, leaf_sizes)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    quickstart(dev)
    launches = main_path(dev)
    cpu_agreement(dev)
    table2_linreg(dev)
    rows = timings(dev, card)
    cnn_step_time(dev)

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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
