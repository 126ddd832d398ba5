"""Hand-written CUDA kernels for the coordinate-wise median / trimmed mean.

Replaces the reference's Pallas TPU kernels
(``src/repro/kernels/robust_agg.py``):

=========================================  =====================================
wrapper here                               TPU kernel replaced
=========================================  =====================================
:func:`median`, :func:`median_many`        ``median_pallas`` (``_median_kernel``)
:func:`trimmed_mean`,                      ``trimmed_mean_pallas``
:func:`trimmed_mean_many`
:func:`fused_median_trimmed`               ``fused_median_trimmed_pallas``
=========================================  =====================================

Median and trimmed mean: every comparator program is compiled in
(:mod:`select_codegen` writes the source, ``csrc/select_program.cuh`` holds
what the programs share) and runs on integer keys in registers; one launch
takes up to ``select_codegen.MAX_LEAVES`` leaves.  :func:`prepare` builds
many programs at once (a few libraries, one nvcc each, in parallel); a
program not prepared is built at its first use.  The fused kernel
(``csrc/robust_agg.cu``) still walks its comparator list at runtime.
Everything is built by :mod:`repro_torch.kernels.build` into
``build/repro_torch/`` at the repository root and loaded with ctypes.
Bound: memory — m*n*s bytes read and n*s written per output (s the element
size); the sources' headers say what the designs do about it.

Device rule: a CPU tensor takes the plain version (the torch executor of
the same comparator program in :mod:`selection_network`); a CUDA tensor
launches the kernel or raises — nothing falls back.  ``LAUNCHES`` counts
kernel launches per wrapper and ``LEAVES`` the leaves they aggregated, so
a run can show that its aggregation went through the kernels.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes
import hashlib
import os
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import select_codegen as G
from repro_torch.kernels import selection_network as SN

SOURCE = _build.CSRC / "robust_agg.cu"
BUILD_DIR = _build.BUILD_DIR

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"median": 0, "trimmed_mean": 0, "fused_median_trimmed": 0}
#: leaves the median / trimmed-mean launches aggregated
LEAVES: Dict[str, int] = {"median": 0, "trimmed_mean": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()
_PAIRS: Dict[Tuple[int, Tuple[int, ...], torch.device], torch.Tensor] = {}
# (kind, m, trim, dtype) -> (C entry, its library); the libraries loaded
_HANDLES: Dict[G.Spec, tuple] = {}
_SELECT_LIBS: List[Path] = []
_PREPARE_LOCK = threading.Lock()


def reset_launches() -> None:
    for counts in (LAUNCHES, LEAVES):
        for k in counts:
            counts[k] = 0


def build() -> Path:
    """Compile the fused kernel (once per source content) and return the
    shared library's path; nvcc's ``-Xptxas -v`` report goes to a ``.log``
    file beside it."""
    return _build.build(SOURCE, BUILD_DIR)


def load() -> ctypes.CDLL:
    """The loaded fused-kernel library (built on first call).  Raises when
    CUDA or nvcc is missing."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = _build.load(SOURCE, "ra_error_string", BUILD_DIR)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ra_fused.argtypes = [p, i, ctypes.c_longlong, p, i, i, p, p, i, p]
            lib.ra_fused.restype = i
            _LIB = lib
    return _LIB


# ------------------------------------------------- compiled-in programs


def _build_select(specs: List[G.Spec]) -> Path:
    source = G.emit_source(specs)
    tag = hashlib.sha256(source.encode()).hexdigest()[:12]
    path = BUILD_DIR / f"select_{tag}.cu"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    return _build.build(path, BUILD_DIR)


def prepare(specs: Iterable[Tuple[str, int, int, torch.dtype]]) -> List[Path]:
    """Build and load the median / trimmed-mean kernels of ``specs``
    ((kind, m, trim, dtype) tuples; the median's trim is ignored): the
    programs not loaded yet are split into up to one library per CPU core
    (at most 8), compiled by parallel nvcc processes.
    Returns the libraries' paths; each has nvcc's ``-Xptxas -v`` report in a
    ``.log`` beside it.  Raises without CUDA or nvcc."""
    _build.require_cuda("robust_agg")
    wanted = {G.spec(*s) for s in specs}
    with _PREPARE_LOCK:
        todo = wanted - set(_HANDLES)
        if not todo:
            return []
        groups = G.partition(list(todo), min(8, os.cpu_count() or 1))
        with cf.ThreadPoolExecutor(len(groups)) as pool:  # one nvcc per library
            paths = list(pool.map(_build_select, groups))
        for group, path in zip(groups, paths):
            lib = _build.load_library(path, "ra_sel_error_string")
            for s in group:
                fn = getattr(lib, G.symbol(s))
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _HANDLES[s] = (fn, lib)
            _SELECT_LIBS.append(path)
    return paths


def select_libraries() -> List[Path]:
    """The median / trimmed-mean libraries loaded so far, in load order."""
    return list(_SELECT_LIBS)


def _handle(kind: str, m: int, trim: int, dtype: torch.dtype):
    key = G.Spec(kind, m, trim if kind == "trimmed_mean" else 0, dtype)
    h = _HANDLES.get(key)
    if h is None:
        prepare([key])
        h = _HANDLES[key]
    return h


# ------------------------------------------------------------- wrappers


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected an (m, n) matrix, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    m, n = x.shape
    if not 1 <= m <= SN.NETWORK_MAX_M:
        raise ValueError(f"the kernels take 1 <= m <= {SN.NETWORK_MAX_M}, got m={m}")
    if n < 1:
        raise ValueError("the kernels need at least one coordinate")
    if not x.is_contiguous():
        raise ValueError("the kernels need a contiguous (m, n) matrix")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_trim(m: int, trim: int) -> None:
    if not (0 <= trim and 2 * trim < m):
        raise ValueError(f"invalid trim {trim} for m={m}")


def plan_for(x: torch.Tensor) -> G.SelectPlan:
    """The launch plan of leaf ``x`` (m, n) (:func:`select_codegen.select_plan`);
    its output segment always starts on a 16-byte boundary."""
    m, n = x.shape
    v = G.coords_per_thread(m, x.dtype)
    return G.select_plan(m, n, x.dtype, x.data_ptr() % (v * x.element_size()) == 0)


def _select_many(kind: str, xs: Sequence[torch.Tensor], trim: int) -> List[torch.Tensor]:
    if not xs:
        return []
    x0 = xs[0]
    _check(x0)
    m, dtype, device = x0.shape[0], x0.dtype, x0.device
    for x in xs:
        # the common case first: on the CNN's small leaves the host time is
        # most of a call
        if not (x.dim() == 2 and x.shape[0] == m and x.dtype == dtype
                and x.is_contiguous() and x.device == device and x.shape[1] >= 1):
            _check(x)
            raise ValueError("the leaves of one call need one m, one dtype and one device; "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device} after "
                             f"{tuple(x0.shape)} {dtype} on {device}")
    if kind == "trimmed_mean":
        _check_trim(m, trim)
    if not x0.is_cuda:
        if kind == "median":
            return [SN.median_select(x) for x in xs]
        return [SN.trimmed_mean_select(x, trim) for x in xs]
    fn, lib = _handle(kind, m, trim, dtype)
    return _launch_many(kind, fn, lib, xs, m, dtype, device)


def _launch_many(kind, fn, lib, xs, m, dtype, device) -> List[torch.Tensor]:
    """Launch ``fn`` over the leaves ``xs`` (checked), MAX_LEAVES at a time,
    into one flat output in which each leaf's segment starts on a 16-byte
    boundary (a gap is left only where the previous segments end off it)."""
    s = torch.finfo(dtype).bits // 8
    width = G.coords_per_thread(m, dtype) * s  # bytes of a V-wide load
    pad = 16 // s
    records, sizes, pieces, total = [], [], [], 0
    for x in xs:
        if total % pad:
            sizes.append(pad - total % pad)
            total += sizes[-1]
        n, xp = x.shape[1], x.data_ptr()
        scalar = G.select_plan(m, n, dtype, xp % width == 0).scalar
        records.append((xp, total * s, n, 0 if scalar else 1))
        pieces.append(len(sizes))
        sizes.append(n)
        total += n
    flat = torch.empty(total, dtype=dtype, device=device)
    base = flat.data_ptr()
    dev = device.index if device.index is not None else torch.cuda.current_device()
    for start in range(0, len(records), G.MAX_LEAVES):
        chunk = records[start:start + G.MAX_LEAVES]
        arr = (ctypes.c_longlong * (4 * len(chunk)))()
        for i, (xp, off, n, vec) in enumerate(chunk):
            arr[4 * i:4 * i + 4] = (xp, base + off, n, vec)
        err = _build.launch_on(dev, lambda stream: fn(arr, len(chunk), stream))
        _build.check_launch(lib, kind, err)
        LAUNCHES[kind] += 1
        LEAVES[kind] += len(chunk)
    parts = flat.split_with_sizes(sizes)
    return [parts[i] for i in pieces]


def median_many(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Coordinate-wise medians of leaves ``xs`` (each (m, n_i), one m, dtype
    and device) -> [(n_i,)], one launch per MAX_LEAVES leaves; the outputs
    are views of one flat buffer."""
    return _select_many("median", xs, 0)


def trimmed_mean_many(xs: Sequence[torch.Tensor], trim: int) -> List[torch.Tensor]:
    """Coordinate-wise trimmed means of leaves ``xs`` over the ranks
    [trim, m - trim), as :func:`median_many`."""
    return _select_many("trimmed_mean", xs, trim)


def median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of ``x`` (m, n) -> (n,), same dtype."""
    return _select_many("median", [x], 0)[0]


def trimmed_mean(x: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean of ``x`` (m, n) -> (n,) over the ranks
    [trim, m - trim)."""
    return _select_many("trimmed_mean", [x], trim)[0]


def _pairs(prog: SN.SelectionProgram, device: torch.device) -> torch.Tensor:
    """The program's comparators as flat uint8 (i, j) pairs on ``device``,
    uploaded once per (m, ranks, device)."""
    key = (prog.m, prog.ranks, device)
    t = _PAIRS.get(key)
    if t is None:
        flat = [w for pair in prog.comparators for w in pair]
        t = _PAIRS[key] = torch.tensor(flat, dtype=torch.uint8).to(device)
    return t


def fused_median_trimmed(x: torch.Tensor, trim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(median, trimmed mean) of ``x`` (m, n) from one read of the rows."""
    _check(x)
    _check_trim(x.shape[0], trim)
    if not x.is_cuda:
        return SN.median_and_trimmed_select(x, trim)
    lib = load()
    m, n = x.shape
    prog = SN.fused_program(m, trim)
    pairs = _pairs(prog, x.device)
    med = torch.empty(n, dtype=x.dtype, device=x.device)
    tm = torch.empty_like(med)
    err = _build.launch_on(x.get_device(), lambda stream: lib.ra_fused(
        x.data_ptr(), m, n, pairs.data_ptr(), prog.size, trim, med.data_ptr(), tm.data_ptr(),
        int(x.dtype == torch.bfloat16), stream))
    _build.check_launch(lib, "fused_median_trimmed", err)
    LAUNCHES["fused_median_trimmed"] += 1
    return med, tm
