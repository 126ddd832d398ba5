"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as one JSON object; the
numbers that decided ``correct`` are also the last lines of standard
error.  Exits non-zero with no result when there is no CUDA device, or
fewer than the cell asks for, or when JAX or the JAX package ``repro``
is loaded once the window has closed.  Build and kernel caches stay in
``build/`` inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _name, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                    ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_name] = str(ROOT / "build" / "chipbench" / _sub)
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from chipbench import bench

    cell = bench.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} asks for {cell.chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(f"chipbench.kinds.{cell.traffic['kind']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     T_START)
    found = bench.forbidden_modules()
    if found:
        print(f"loaded in the measured process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in bench.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    print(bench.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"],
                            out["device"], out["checks"], out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
