#!/usr/bin/env python3
"""Time variants of the compiled-in order-statistic kernels (B1 median, B2
trimmed mean, B3 both from one read) on one CUDA card.

    python3 scripts/select_variants.py   # needs one CUDA card and nvcc

1. The integer min/max rate the design assumes: a kernel of odd-even
   transposition passes over 16 registers a thread (15 exchanges, 30
   min/max a pass), with 32-bit keys (``min``/``max``) and with packed
   16-bit pairs (``__vmins2``/``__vmaxs2``), and the SASS instructions each
   compiles to.
2. Ablations of the shipped kernel: each a copy of
   ``src/repro_torch/kernels/csrc/select_program.cuh`` with one part
   changed, placed beside a generated source (so that the copy is the
   header it includes), built into its own library under
   ``build/select_variants/``: the shipped kernel, without the comparator
   program (loads, keys, NaN flag, decoding and stores alone), and without
   the NaN flag.  They give wrong answers and are timed, not checked.
3. Coordinates per thread (V) for the m=32 f32 programs: V in {1, 2, 4},
   each output checked bitwise against the shipped V.

Shapes: m=32, n=2^24 in f32 and bf16 (median, trim 3, fused trim 3), and
the CNN's fc1 leaf (m=10, n=50,176, f32).  Times are CUDA-event times per call over 20
calls after a warm-up, taken through the C entry points; every line names
the card and its power limit.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "select_variants"

# name -> (edits of the header, edits of the generated source)
VARIANTS = {
    "shipped": ([], []),
    "no program": ([("  P::template run<K, W>(k);\n", "")], []),
    "no NaN flag": ([("        mag[w] = __vmaxu2(mag[w], raw[i][w] & 0x7fff7fffu);\n", ""),
                     ("        mag[w] = max(mag[w], raw[i][w] & 0x7fffffffu);\n", "")], []),
}
SHAPES = (("bandwidth", 32, 1 << 24, "float32"), ("bandwidth", 32, 1 << 24, "bfloat16"),
          ("cnn fc1 leaf", 10, 50176, "float32"))
COORDS = (1, 2, 4)
for _v in COORDS:  # V of the m=32 programs (the f32 ones are timed)
    VARIANTS[f"m=32 f32 V={_v}"] = ([], [(f"{p}, 2, sel::{k}", f"{p}, {_v}, sel::{k}")
                                         for p, k in (("med_m32", "kMedian"),
                                                      ("tm_m32_t3", "kTrimmed"),
                                                      ("fu_m32_t3", "kFused"))])
KINDS = ("median", "trimmed_mean", "fused_median_trimmed")

RATE_SOURCE = r"""
#include <cuda_runtime.h>
template <int kMode>
__device__ __forceinline__ void cx(int& a, int& b) {
  int lo, hi;
  if (kMode == 0) { lo = min(a, b); hi = max(a, b); }
  else { lo = (int)__vmins2((unsigned)a, (unsigned)b); hi = (int)__vmaxs2((unsigned)a, (unsigned)b); }
  a = lo; b = hi;
}
template <int kMode>
__global__ void rate_kernel(int* out, int iters, int seed) {
  int a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = seed * (threadIdx.x + 13 * i) ^ (blockIdx.x * (i + 1));
  for (int t = 0; t < iters; ++t) {
#pragma unroll
    for (int i = 0; i < 16; i += 2) cx<kMode>(a[i], a[i + 1]);
#pragma unroll
    for (int i = 1; i < 15; i += 2) cx<kMode>(a[i], a[i + 1]);
    a[15] ^= t;
  }
  int r = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) r += a[i] * (i + 1);
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}
extern "C" int rate(int mode, int* out, int blocks, int threads, int iters, int seed) {
  if (mode == 0) rate_kernel<0><<<blocks, threads>>>(out, iters, seed);
  else rate_kernel<1><<<blocks, threads>>>(out, iters, seed);
  return (int)cudaGetLastError();
}
extern "C" const char* rate_error(int e) { return cudaGetErrorString((cudaError_t)e); }
"""


def specs():
    import torch

    from repro_torch.kernels import select_codegen as G

    out = []
    for _, m, _, dt in SHAPES:
        dtype = getattr(torch, dt)
        out += [G.spec(kind, m, int(0.1 * m), dtype) for kind in KINDS]
    return out


def variant_dir(name: str) -> Path:
    return OUT / re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


def write_variant(name: str, header_edits, source_edits) -> Path:
    """A directory holding the generated source and its (edited) header."""
    from repro_torch.kernels import select_codegen as G

    header = G.HEADER.read_text()
    for old, new in header_edits:
        if old not in header:
            raise SystemExit(f"the header no longer contains {old!r}")
        header = header.replace(old, new)
    source = G.emit_source(specs())
    for old, new in source_edits:
        if old not in source:
            raise SystemExit(f"the generated source no longer contains {old!r}")
        source = source.replace(old, new)
    d = variant_dir(name)
    d.mkdir(parents=True, exist_ok=True)
    (d / "select_program.cuh").write_text(header)
    # the header's text is part of the source's content hash, so a changed
    # header gets a library of its own
    tag = hashlib.sha256(header.encode()).hexdigest()[:16]
    (d / "select.cu").write_text(f"// variant {name}, header sha256 {tag}\n" + source)
    return d / "select.cu"


def load(path: Path):
    """(library, ptxas maxima line) of a variant source."""
    import chip_smoke as C
    from repro_torch.kernels import build as B

    lib_path = B.build(path, path.parent)
    regs, spill, stack, kernels = C.ptxas_report(lib_path)
    return ctypes.CDLL(str(lib_path)), {"kernels": kernels, "max_registers": regs,
                                        "spill_bytes": spill, "stack_bytes": stack}


def entry(lib, s):
    from repro_torch.kernels import select_codegen as G

    fn = getattr(lib, G.symbol(s))
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, x, outs, coords):
    """One launch of an entry on one leaf (vector loads where they can be);
    ``outs`` holds the kernel's one output, or the fused kernel's two."""
    import torch

    n = x.shape[1]
    width = coords * x.element_size()
    ptrs = [o.data_ptr() for o in outs] + [0]  # the second output, or null
    vec = int((x.data_ptr() | ptrs[0] | ptrs[1]) % width == 0 and n % coords == 0)
    arr = (ctypes.c_longlong * 5)(x.data_ptr(), ptrs[0], ptrs[1], n, vec)
    err = fn(arr, 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: {err}")


def rate_probe(card: str) -> None:
    import torch

    from repro_torch.kernels import build as B

    d = OUT / "rate"
    d.mkdir(parents=True, exist_ok=True)
    src = d / "rate.cu"
    src.write_text(RATE_SOURCE)
    lib_path = B.build(src, d)
    cuobj = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobj, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    lib = ctypes.CDLL(str(lib_path))
    lib.rate.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
    blocks, threads, iters = 132 * 8, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    funcs = {f.split()[0]: f for f in sass.split("Function : ")[1:]}
    for mode, label in ((0, "int32 min/max"), (1, "16x2 __vmins2/__vmaxs2")):
        body = next(f for name, f in funcs.items() if f"ILi{mode}E" in name)
        ops = collections.Counter(re.findall(r"\b((?:VI|I|V)MNMX[A-Z0-9.]*|PRMT|IADD3|"
                                             r"LOP3[A-Z0-9.]*|SEL|ISETP[A-Z0-9.]*)\b", body))
        for _ in range(2):
            lib.rate(mode, out.data_ptr(), blocks, threads, iters, 3)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lib.rate(mode, out.data_ptr(), blocks, threads, iters, 3)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        minmax = blocks * threads * iters * 30
        clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True).stdout.split()[0]
        print(json.dumps({"rate": label, "ms": ms, "minmax_per_s": minmax / ms * 1e3,
                          "per_sm_per_clock_at_sampled_clock":
                          minmax / (ms * 1e-3) / 132 / (float(clk) * 1e6),
                          "sm_clock_mhz_after": float(clk), "sass": dict(ops), "card": card}),
              flush=True)


def main() -> None:
    import torch

    import chip_smoke as C
    from repro_torch.kernels import select_codegen as G

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script times kernels on the card")
    card = C.card_line()
    print(f"card: {card}", flush=True)
    rate_probe(card)

    paths = {name: write_variant(name, *edits) for name, edits in VARIANTS.items()}
    with cf.ThreadPoolExecutor(len(paths)) as pool:  # one nvcc each, together
        built = dict(zip(paths, pool.map(load, paths.values())))
    libs = {name: lib for name, (lib, _) in built.items()}
    for name, (_, report) in built.items():
        print(json.dumps({"variant": name, "ptxas": report, "card": card}), flush=True)

    for label, m, n, dt in SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(m, n, device="cuda").to(dtype)
        reps = 20 if n >= 1 << 20 else 200
        for kind in KINDS:
            s = G.spec(kind, m, int(0.1 * m), dtype)
            shipped_v = G.coords_per_thread(m, dtype)
            b_ms, _ = C.bound(kind, m, n, s.trim, x.element_size())
            outputs = 2 if kind == "fused_median_trimmed" else 1
            want = [torch.empty(n, dtype=dtype, device="cuda") for _ in range(outputs)]
            call(entry(libs["shipped"], s), x, want, shipped_v)
            for name, lib in libs.items():
                v = shipped_v
                if name.startswith("m=32 f32 V="):
                    if (m, dt) != (32, "float32"):
                        continue
                    v = int(name.rsplit("=", 1)[1])
                fn = entry(lib, s)
                out = [torch.empty(n, dtype=dtype, device="cuda") for _ in range(outputs)]
                ms = C.time_ms(lambda: call(fn, x, out, v), reps)
                dev_ms = C.device_ms(lambda: call(fn, x, out, v), 20, "leaf_select_kernel")
                checked = None
                if name.startswith("m=32 f32 V="):
                    checked = all(C.compare(o, w)[0] == 0 for o, w in zip(out, want))
                print(json.dumps({"variant": name, "shape": label, "kernel": kind, "m": m,
                                  "n": n, "dtype": dt, "coords": v, "ms": ms,
                                  "device_ms": dev_ms, "bound_ms": b_ms,
                                  "bitwise_equal_to_shipped": checked, "card": card}),
                      flush=True)
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
