"""Launch plan and CUDA source of the order-statistic kernels B1 (median),
B2 (trimmed mean) and B3 (median and trimmed mean from one read).

Each comparator program of :mod:`selection_network` (``median_program(m)``,
``trimmed_program(m, trim)``, ``fused_program(m, trim)``) is compiled in:
the generator emits one ``CX(i, j)`` per comparator, in the program's
order, into a struct whose ``run`` works on the thread's key registers
``k[m][W]`` (an int32 key per f32 coordinate, two 16-bit keys per register
for bf16 and f16) with compile-time indices, so the column lives in registers and
no comparator list lives in memory.  The fused program has the trimmed program's comparators and
ranks (the band [trim, m - trim) holds the median ranks, as 2·trim < m),
so B3 is B2 with a second output read from the same keys.
Every (program, dtype) gets one ``extern "C"`` entry that launches
``leaf_select_kernel`` over up to :data:`MAX_LEAVES` leaves.  What the
programs share (keys, the NaN flag, loads, the midpoint, the band sum,
stores, the launch) is the hand-written header ``csrc/select_program.cuh``.

The generated ``.cu`` files are written to ``build/repro_torch/`` (git
ignores it) by :func:`repro_torch.kernels.robust_agg.prepare`, which
builds many programs per library and a few libraries in parallel.

The launch plan is chosen here, in Python, so that the CPU tests can pin
it: :func:`coords_per_thread` (V, from a register budget of m·V keys) and
:func:`select_plan` (V-wide loads or the scalar path, per leaf).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Iterable, List, NamedTuple, Sequence

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import selection_network as SN

HEADER = _build.CSRC / "select_program.cuh"
KINDS = ("median", "trimmed_mean", "fused_median_trimmed")
#: threads per block (``sel::kThreads`` in the header)
THREADS = 128
#: leaves one launch takes, passed by value in the kernel's parameters
#: (``sel::kMaxLeaves`` in the header)
MAX_LEAVES = 32
#: 32-bit registers of keys a thread holds: m * V (f32) or m * V / 2 (bf16
#: and f16, two 16-bit keys a register) <= KEY_BUDGET
KEY_BUDGET = 64

_DTYPES = {torch.float32: ("f32", "float"), torch.bfloat16: ("bf16", "__nv_bfloat16"),
           torch.float16: ("f16", "__half")}
#: the element types the kernels take
DTYPES = tuple(_DTYPES)


class Spec(NamedTuple):
    """One compiled kernel: a program (kind, m, trim) in one dtype.  The
    median's trim is 0."""

    kind: str
    m: int
    trim: int
    dtype: torch.dtype


def spec(kind: str, m: int, trim: int, dtype: torch.dtype) -> Spec:
    """A validated :class:`Spec` (the median's trim is set to 0)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; want one of {KINDS}")
    if dtype not in _DTYPES:
        raise TypeError(f"expected float32, bfloat16 or float16, got {dtype}")
    if not 1 <= m <= SN.NETWORK_MAX_M:
        raise ValueError(f"the kernels take 1 <= m <= {SN.NETWORK_MAX_M}, got m={m}")
    if kind == "median":
        trim = 0
    elif not (0 <= trim and 2 * trim < m):
        raise ValueError(f"invalid trim {trim} for m={m}")
    return Spec(kind, m, trim, dtype)


def program(kind: str, m: int, trim: int) -> SN.SelectionProgram:
    """The pruned comparator program a kernel runs."""
    if kind == "median":
        return SN.median_program(m)
    if kind == "trimmed_mean":
        return SN.trimmed_program(m, trim)
    return SN.fused_program(m, trim)


@functools.lru_cache(maxsize=None)
def coords_per_thread(m: int, dtype: torch.dtype) -> int:
    """V, the coordinates a thread owns: the widest load (16 bytes: 4 f32
    or 8 bf16 / f16) halved until the thread's key registers (m * V for f32,
    m * V / 2 for the 16-bit types) fit KEY_BUDGET.  The 16-bit types keep
    V >= 2: their keys come in pairs."""
    if dtype == torch.float32:
        v, per_register, least = 4, 1, 1
    else:
        v, per_register, least = 8, 2, 2
    while v > least and m * v > KEY_BUDGET * per_register:
        v //= 2
    return v


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    coords: int  # V: coordinates per thread (a compile-time constant)
    load_bytes: int  # bytes one load of one row moves
    threads: int  # threads per block
    scalar: bool  # the leaf takes element-wide loads with a bounds check


@functools.lru_cache(maxsize=4096)
def select_plan(m: int, n: int, dtype: torch.dtype, aligned: bool) -> SelectPlan:
    """How one leaf of ``n`` coordinates is launched.  ``aligned``: the
    leaf's input and output pointers are multiples of the vector width
    (V elements).  Row i starts at byte i*n*s, so V-wide loads need that and
    n % V == 0; otherwise the leaf takes the scalar path (thread t of a
    tile owns coordinates t, t + THREADS, ...), which also masks the ragged
    edge."""
    v = coords_per_thread(m, dtype)
    s = 4 if dtype == torch.float32 else 2
    scalar = not (aligned and n % v == 0)
    return SelectPlan(coords=v, load_bytes=s if scalar else v * s, threads=THREADS,
                      scalar=scalar)


# ----------------------------------------------------------------- source


# a program's struct name prefix and its sel:: kind constant
_NAMES = {"median": ("med", "sel::kMedian"), "trimmed_mean": ("tm", "sel::kTrimmed"),
          "fused_median_trimmed": ("fu", "sel::kFused")}


def program_name(kind: str, m: int, trim: int) -> str:
    """The program's struct name, one per (kind, m, trim), so that a source
    holding the trimmed and the fused kernel of one (m, trim) defines each
    struct once."""
    prefix = _NAMES[kind][0]
    return f"{prefix}_m{m}" if kind == "median" else f"{prefix}_m{m}_t{trim}"


def symbol(s: Spec) -> str:
    """The C entry of a kernel, e.g. ``ra_sel_med_m10_f32``."""
    return f"ra_sel_{program_name(s.kind, s.m, s.trim)}_{_DTYPES[s.dtype][0]}"


def emit_program(kind: str, m: int, trim: int) -> str:
    """The program as a struct: one CX(i, j) per comparator, in order."""
    prog = program(kind, m, trim)
    what = {"median": "median", "trimmed_mean": f"trim-{trim} band",
            "fused_median_trimmed": f"median and trim-{trim} band"}[kind]
    lines = [f"// {what} of m={m}: {prog.size} comparators (pruned from {prog.full_size})",
             f"struct {program_name(kind, m, trim)} {{",
             f"  static constexpr int kM = {m};",
             "  template <typename K, int W>",
             "  static __device__ __forceinline__ void run(K (&k)[kM][W]) {"]
    if not prog.comparators:
        lines.append("    (void)k;  // no comparators")
    row: List[str] = []
    for i, j in prog.comparators:
        row.append(f"CX({i}, {j});")
        if len(row) == 8:
            lines.append("    " + " ".join(row))
            row = []
    if row:
        lines.append("    " + " ".join(row))
    lines += ["  }", "};"]
    return "\n".join(lines)


def emit_source(specs: Iterable[Spec]) -> str:
    """A translation unit holding the kernels of ``specs``.  It names the
    header's hash, so that a changed header changes the library's hash."""
    specs = sorted(set(specs), key=spec_key)
    header_hash = hashlib.sha256(HEADER.read_bytes()).hexdigest()[:16]
    out = ["// Generated by src/repro_torch/kernels/select_codegen.py from the comparator",
           "// programs of selection_network.py; do not edit.",
           f"// select_program.cuh sha256 {header_hash}",
           '#include "select_program.cuh"', "", "namespace {", ""]
    for kind, m, trim in sorted({(s.kind, s.m, s.trim) for s in specs}):
        out += [emit_program(kind, m, trim), ""]
    out += ["}  // namespace", ""]
    for s in specs:
        out += [f'extern "C" int {symbol(s)}(const long long* leaves, int nleaves, '
                f"void* stream) {{",
                f"  return sel::launch<{_DTYPES[s.dtype][1]}, "
                f"{program_name(s.kind, s.m, s.trim)}, "
                f"{coords_per_thread(s.m, s.dtype)}, {_NAMES[s.kind][1]}, {s.trim}>"
                f"(leaves, nleaves, stream);",
                "}", ""]
    out += ['extern "C" const char* ra_sel_error_string(int err) {',
            "  return cudaGetErrorString((cudaError_t)err);", "}", ""]
    return "\n".join(out)


def spec_key(s: Spec):
    """A sort key of specs (torch dtypes do not order)."""
    return (s.kind, s.m, s.trim, _DTYPES[s.dtype][0])


def cost(s: Spec) -> int:
    """Rough size of a kernel's code: exchanges plus loads, times V."""
    return (program(s.kind, s.m, s.trim).size + s.m) * coords_per_thread(s.m, s.dtype)


def partition(specs: Sequence[Spec], jobs: int) -> List[List[Spec]]:
    """Split ``specs`` into at most ``jobs`` groups of about equal
    :func:`cost` (largest first, each to the lightest group), each group
    sorted, so that the same specs always give the same sources."""
    specs = sorted(set(specs), key=spec_key)
    groups: List[List[Spec]] = [[] for _ in range(max(1, min(jobs, len(specs))))]
    load = [0] * len(groups)
    for s in sorted(specs, key=lambda s: (-cost(s), spec_key(s))):
        g = load.index(min(load))
        groups[g].append(s)
        load[g] += cost(s)
    return [sorted(g, key=spec_key) for g in groups if g]
