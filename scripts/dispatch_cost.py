#!/usr/bin/env python3
"""Host time of a kernel launch through the wrappers, on one CUDA card.

    python3 scripts/dispatch_cost.py [--src DIR] [--alt] [--label NAME]

Times the port under ``DIR`` (default: this checkout's ``src``; a parent
commit's tree unpacked with ``git archive`` works too) in one process:

- ``cnn_step_ms``: one Algorithm 1 step on the paper's CNN, chip_smoke's
  phase 4 path (m = 10, the 8 leaves in one launch a step), host clock
  around 50 steps ending in a synchronize, after 5 warm-up steps, median
  of 5 such runs, for the median and the trimmed mean;
- ``call_us``: one wrapper call, host clock over 2,000 calls ending in a
  synchronize (the calls are host-bound), median of 5 runs: the median,
  trimmed-mean and fused kernels on the CNN's 8 leaves at m = 10 (f32),
  min/max and the histogram (512 bins, with sums) at the federated chunk
  (512 x 32 f32).

With ``--alt`` the same calls also go through a ``torch.library.custom_op``
registration of the same CUDA implementations (namespace
``repro_torch_alt``), the other registration the port could use; the
shipped one is ``torch.library.Library(...).impl``.  Prints one JSON line.
Compare two trees in one machine, in turns (parent, change, change,
parent): the card's clocks move between machines.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CNN_LEAF_SIZES = (144, 16, 2304, 16, 50176, 64, 640, 10)


def _median_of(fn, runs: int = 5) -> float:
    return statistics.median(fn() for _ in range(runs))


def _per_call_us(fn, calls: int = 2000) -> float:
    import torch

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    fn()
    return _median_of(run)


def _alt_ops():
    """The custom_op registration of the port's CUDA implementations."""
    import torch

    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg as R

    @torch.library.custom_op("repro_torch_alt::select", mutates_args=(), device_types="cuda")
    def select(kind: str, trim: int, xs: list[torch.Tensor]) -> torch.Tensor:
        return R._select_cuda(kind, trim, xs)

    @torch.library.custom_op("repro_torch_alt::minmax", mutates_args=(), device_types="cuda")
    def minmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return H._minmax_cuda(x)

    @torch.library.custom_op("repro_torch_alt::histogram", mutates_args=(),
                             device_types="cuda")
    def histogram(x: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, nbins: int,
                  with_sums: bool) -> list[torch.Tensor]:
        return H._histogram_cuda(x, lo, width, nbins, with_sums)

    return select, minmax, histogram


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--alt", action="store_true")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("dispatch_cost: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import make_robust_gd_stages
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg as R
    from repro_torch.models.paper_models import cnn_loss
    from repro_torch.rounds import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    R.prepare([(k, 10, 1, torch.float32) for k in ("median", "trimmed_mean",
                                                   "fused_median_trimmed")])
    H.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"label": args.label, "src": args.src, "card": card.strip().splitlines()[0],
           "torch": torch.__version__, "cnn_step_ms": {}, "call_us": {}}

    shards, params = C.cnn_setup(dev)
    for method in ("median", "trimmed_mean"):
        stages = make_robust_gd_stages(cnn_loss, shards, C.cnn_config(method, 10),
                                       AttackConfig(**C.CNN_ATTACK))
        body = engine.make_round_body(stages)
        state = [engine.make_state(params), 0]

        def steps(k):
            for _ in range(k):
                state[0], _ = body(state[0], state[1])
                state[1] += 1

        steps(5)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(50)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / 50 * 1e3

        out["cnn_step_ms"][method] = _median_of(run)

    g = torch.Generator(device=dev).manual_seed(0)
    leaves = [torch.randn(10, n, device=dev, generator=g) for n in CNN_LEAF_SIZES]
    chunk = torch.randn(512, 32, device=dev, generator=g)
    lo, hi = H.minmax(chunk)
    lo, width = H.edges(lo, hi, 512)
    calls = {
        "median x8": lambda: R.median_many(leaves),
        "trimmed_mean x8": lambda: R.trimmed_mean_many(leaves, 1),
        "fused x8": lambda: R.fused_median_trimmed_many(leaves, 1),
        "minmax fed chunk": lambda: H.minmax(chunk),
        "histogram fed chunk": lambda: H.histogram(chunk, lo, width, 512),
    }
    if args.alt:
        select, minmax, histogram = _alt_ops()
        calls.update({
            "median x8 custom_op": lambda: select("median", 0, leaves),
            "trimmed_mean x8 custom_op": lambda: select("trimmed_mean", 1, leaves),
            "fused x8 custom_op": lambda: select("fused_median_trimmed", 1, leaves),
            "minmax fed chunk custom_op": lambda: minmax(chunk),
            "histogram fed chunk custom_op": lambda: histogram(chunk, lo, width, 512, True),
        })
        if hasattr(torch.ops.repro_torch, "select"):  # the shipped op, bare
            op = torch.ops.repro_torch
            calls.update({
                "median x8 op": lambda: op.select("median", 0, leaves),
                "minmax fed chunk op": lambda: op.minmax(chunk),
                "histogram fed chunk op": lambda: op.histogram(chunk, lo, width, 512, True),
                "median x8 impl": lambda: R._select_cuda("median", 0, leaves),
                "minmax fed chunk impl": lambda: H._minmax_cuda(chunk),
                "histogram fed chunk impl": lambda: H._histogram_cuda(chunk, lo, width, 512,
                                                                      True),
            })
    for name, fn in calls.items():
        out["call_us"][name] = _per_call_us(fn)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
