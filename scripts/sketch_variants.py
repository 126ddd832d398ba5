#!/usr/bin/env python3
"""Time variants of the streaming-sketch histogram kernel (B5) on one CUDA card.

    python3 scripts/sketch_variants.py   # needs one CUDA card and nvcc

It builds copies of ``src/repro_torch/kernels/csrc/histogram_agg.cu`` with
one part changed (each copy its own library, by content hash, under
``build/sketch_variants/``) and times them with CUDA events through the C
entry point, so that a finding about what sets the kernel's time can be
checked:

1. ablations at the federated chunk (512 x 32, 512 bins) and at 256 x 2^20
   x 128 bins: the shipped kernel, without the sums walk, and with the bin's
   division replaced by a multiply (both give wrong sums; they are timed,
   not checked);
2. launch plans at 256 x 2^20 x 128 bins, f32 and bf16, with and without
   sums: column tile x threads a block x rows a thread loads (``kLoads``),
   each output checked bitwise against the shipped plan's.

Every line names the card and its power limit.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ABLATIONS = {
    "shipped": [],
    "no sums walk": [("if (kSums && t < cols) {", "if (false) {")],
    "multiply, no division": [
        ("floorf(__fdiv_rn(__fsub_rn(v, l), safe_w))", "floorf((v - l) * safe_w)"),
    ],
}
LOADS = (8, 16)
PLANS = ((32, 128), (32, 256), (16, 256), (64, 256), (64, 512), (128, 512))


def variant_source(edits) -> str:
    from repro_torch.kernels import histogram_agg as H

    src = H.SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"the source no longer contains {old!r}")
        src = src.replace(old, new)
    return src


def build_all(variants: dict) -> dict:
    from repro_torch.kernels import build as B

    out_dir = ROOT / "build" / "sketch_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def one(item):
        name, edits = item
        path = out_dir / (name.replace(" ", "_").replace(",", "") + ".cu")
        path.write_text(variant_source(edits))
        lib = ctypes.CDLL(str(B.build(path, out_dir)))
        lib.hg_histogram.argtypes = [p, i, ll, p, p, i, p, p, i, i, i, i, i, p]
        return name, lib

    with cf.ThreadPoolExecutor(len(variants)) as pool:  # one nvcc each, together
        return dict(pool.map(one, variants.items()))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script times kernels on the card")
    from chip_smoke import card_line, time_ms
    from repro_torch.kernels import histogram_agg as H

    card = card_line()
    dev = torch.device("cuda", 0)
    variants = dict(ABLATIONS)
    for k in LOADS[1:]:
        variants[f"kLoads {k}"] = [
            ("constexpr int kLoads = 8;", f"constexpr int kLoads = {k};"),
        ]
    libs = build_all(variants)

    def call(lib, x, lo, w, nbins, sums, plan):
        counts = torch.empty((nbins, x.shape[1]), device=dev)
        out = torch.empty_like(counts) if sums else None
        err = lib.hg_histogram(
            x.data_ptr(),
            x.shape[0],
            x.shape[1],
            lo.data_ptr(),
            w.data_ptr(),
            nbins,
            counts.data_ptr(),
            None if out is None else out.data_ptr(),
            int(x.dtype == torch.bfloat16),
            plan.log2_tile,
            plan.threads,
            plan.stage_rows,
            plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
        if err:
            raise SystemExit(f"launch failed ({err}) for {plan}")
        return counts, out

    def inputs(rows, n, nbins, dtype):
        x = (3 * torch.randn(rows, n, device=dev)).to(dtype)
        lo, width = H.edges(*H.minmax(x), nbins)
        return x, lo, width

    for rows, n, nbins in ((512, 32, 512), (256, 1 << 20, 128)):
        x, lo, w = inputs(rows, n, nbins, torch.float32)
        reps = 20 if n > 4096 else 500
        for sums in (True, False):
            plan = H.histogram_plan(rows, n, nbins, sums)
            ms = {}
            for name in ABLATIONS:
                lib = libs[name]
                ms[name] = time_ms(lambda: call(lib, x, lo, w, nbins, sums, plan), reps)
            line = {
                "ablation": f"{rows} x {n}, {nbins} bins",
                "with_sums": sums,
                "plan": plan.__dict__,
                "ms": ms,
                "card": card,
            }
            print(json.dumps(line))

    for dtype in (torch.float32, torch.bfloat16):
        x, lo, w = inputs(256, 1 << 20, 128, dtype)
        for sums in (True, False):
            want = H.histogram(x, lo, w, 128, sums)
            ms = {}
            for k in LOADS:
                lib = libs["shipped" if k == 8 else f"kLoads {k}"]
                for tile, threads in PLANS:
                    stage = min(256, k * threads // tile)
                    smem = H.histogram_smem_bytes(128, sums, tile, stage)
                    plan = H.HistogramPlan(tile, threads, stage, smem)
                    got = call(lib, x, lo, w, 128, sums, plan)
                    if not all(torch.equal(g, v) for g, v in zip(got, want) if v is not None):
                        raise SystemExit(f"plan {plan}, kLoads {k}: not the shipped plan's bits")
                    key = f"tile {tile}, {threads} threads, kLoads {k}"
                    ms[key] = time_ms(lambda: call(lib, x, lo, w, 128, sums, plan), 10)
            line = {
                "plans": "256 x 2^20, 128 bins",
                "dtype": str(dtype),
                "with_sums": sums,
                "shipped": H.histogram_plan(256, 1 << 20, 128, sums).__dict__,
                "ms": ms,
                "card": card,
            }
            print(json.dumps(line))
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
