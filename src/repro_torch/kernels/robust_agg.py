"""Hand-written CUDA kernels for the coordinate-wise median / trimmed mean.

Replaces the reference's Pallas TPU kernels
(``src/repro/kernels/robust_agg.py``):

=========================================  =====================================
wrapper here                               TPU kernel replaced
=========================================  =====================================
:func:`median`, :func:`median_many`        ``median_pallas`` (``_median_kernel``)
:func:`trimmed_mean`,                      ``trimmed_mean_pallas``
:func:`trimmed_mean_many`
:func:`fused_median_trimmed`,              ``fused_median_trimmed_pallas``
:func:`fused_median_trimmed_many`
=========================================  =====================================

Every comparator program is compiled in (:mod:`select_codegen` writes the
source, ``csrc/select_program.cuh`` holds what the programs share) and runs
on integer keys in registers; one launch takes up to
``select_codegen.MAX_LEAVES`` leaves.  The fused kernel is the trimmed
kernel's program with a second output (the median, from the same keys).
:func:`prepare` builds many programs at once (a few libraries, one nvcc
each, in parallel); a program not prepared is built at its first use.
Everything is built by :mod:`repro_torch.kernels.build` into
``build/repro_torch/`` at the repository root and loaded with ctypes.
The kernels take float32, bfloat16 and float16 leaves (float16 keys are
packed two to a register, as bfloat16's).  Bound: memory — m*n*s bytes read
and n*s written per output (s the element size); the header says what the
design does about it.

Device rule: a CPU tensor takes the plain version (the torch executor of
the same comparator program in :mod:`selection_network`); a CUDA tensor
launches the kernel or raises — nothing falls back; a meta tensor (a
dry-run's stand-in) gets the outputs' shapes.  ``LAUNCHES`` counts
kernel launches per wrapper and ``LEAVES`` the leaves they aggregated, so
a run can show that its aggregation went through the kernels.

A CUDA call goes through the dispatcher op ``torch.ops.repro_torch.select``
(``kind``, ``trim``, the leaves) -> the one flat output buffer the kernel
writes, which the wrapper splits into the leaves' views.  Its CUDA
implementation is the ctypes launch; its fake implementation returns the
buffer's shape and dtype and builds nothing, so a fake or meta tensor (a
dry-run's stand-in, :mod:`repro_torch.launch.dryrun`) passes through the
wrapper, and a dispatch mode sees every launch.
"""
from __future__ import annotations

import concurrent.futures as cf
import ctypes
import functools
import hashlib
import os
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from repro_torch.device import takes_kernels
from repro_torch.kernels import build as _build
from repro_torch.kernels import select_codegen as G
from repro_torch.kernels import selection_network as SN

BUILD_DIR = _build.BUILD_DIR
FUSED = "fused_median_trimmed"
#: the element types the kernels take
DTYPES = G.DTYPES

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {k: 0 for k in G.KINDS}
#: leaves those launches aggregated
LEAVES: Dict[str, int] = {k: 0 for k in G.KINDS}

# (kind, m, trim, dtype) -> (C entry, its library); the libraries loaded
_HANDLES: Dict[G.Spec, tuple] = {}
_SELECT_LIBS: List[Path] = []
_PREPARE_LOCK = threading.Lock()


def reset_launches() -> None:
    for counts in (LAUNCHES, LEAVES):
        for k in counts:
            counts[k] = 0


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
    """Build and load the kernels of ``specs`` ((kind, m, trim, dtype)
    tuples, kind one of ``select_codegen.KINDS``; the median's trim is
    ignored): the
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
    """The order-statistic libraries loaded so far, in load order."""
    return list(_SELECT_LIBS)


def _handle(kind: str, m: int, trim: int, dtype: torch.dtype):
    key = G.Spec(kind, m, 0 if kind == "median" else trim, dtype)
    h = _HANDLES.get(key)
    if h is None:
        prepare([key])
        h = _HANDLES[key]
    return h


# ------------------------------------------------------------- wrappers


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected an (m, n) matrix, got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"expected float32, bfloat16 or float16, got {x.dtype}")
    m, n = x.shape
    if not 1 <= m <= SN.NETWORK_MAX_M:
        raise ValueError(f"the kernels take 1 <= m <= {SN.NETWORK_MAX_M}, got m={m}")
    if n < 1:
        raise ValueError("the kernels need at least one coordinate")
    if not x.is_contiguous():
        raise ValueError("the kernels need a contiguous (m, n) matrix")
    if x.device.type not in ("cpu", "cuda", "meta"):
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


def _select_many(kind: str, xs: Sequence[torch.Tensor], trim: int) -> List[List[torch.Tensor]]:
    """The outputs of ``kind`` on leaves ``xs``: one list of (n_i,) tensors
    per output (two for the fused kernel: medians, then trimmed means)."""
    outputs = 2 if kind == FUSED else 1
    if not xs:
        return [[] for _ in range(outputs)]
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
    if kind != "median":
        _check_trim(m, trim)
    if not takes_kernels(x0):
        if kind == "median":
            return [[SN.median_select(x) for x in xs]]
        if kind == "trimmed_mean":
            return [[SN.trimmed_mean_select(x, trim) for x in xs]]
        return [list(outs) for outs in zip(*(SN.median_and_trimmed_select(x, trim)
                                             for x in xs))]
    flat = _SELECT(kind, trim, xs)
    _, sizes, pieces, _ = _layout(xs, dtype, kind == FUSED)
    parts = flat.split_with_sizes(sizes + sizes if kind == FUSED else sizes)
    result = [[parts[i] for i in pieces]]
    if kind == FUSED:
        result.append([parts[len(sizes) + i] for i in pieces])
    return result


def _layout(xs, dtype, fused: bool):
    """The flat output of leaves ``xs``: (each leaf's offset, the segment
    sizes, each leaf's segment index, the elements an output takes), cached
    by the leaves' widths (the wrapper's host time is most of a call on
    small leaves)."""
    return _layout_of(tuple(x.shape[1] for x in xs), 16 // dtype.itemsize, fused)


@functools.lru_cache(maxsize=4096)
def _layout_of(ns: Tuple[int, ...], pad: int, fused: bool):
    """:func:`_layout` of widths ``ns``: each leaf's segment starts on a
    16-byte boundary (``pad`` elements; a gap is left only where the
    previous segments end off it); the fused kernel's two outputs are the
    halves of one buffer, each leaf at the same offset in both."""
    offsets, sizes, pieces, total = [], [], [], 0
    for n in ns:
        if total % pad:
            sizes.append(pad - total % pad)
            total += sizes[-1]
        offsets.append(total)
        pieces.append(len(sizes))
        sizes.append(n)
        total += n
    if fused and total % pad:  # the second half starts on a 16-byte boundary too
        sizes.append(pad - total % pad)
        total += sizes[-1]
    return tuple(offsets), tuple(sizes), tuple(pieces), total


def _select_cuda(kind: str, trim: int, xs: List[torch.Tensor]) -> torch.Tensor:
    """The op's CUDA implementation: launch ``kind``'s program over the
    (checked) leaves ``xs``, MAX_LEAVES at a time, into one flat buffer
    (:func:`_layout`)."""
    x0 = xs[0]
    m, dtype, device = x0.shape[0], x0.dtype, x0.device
    fn, lib = _handle(kind, m, trim, dtype)
    s = dtype.itemsize
    width = G.coords_per_thread(m, dtype) * s  # bytes of a V-wide load
    fused = kind == FUSED
    offsets, _, _, total = _layout(xs, dtype, fused)
    records = []
    for x, off in zip(xs, offsets):
        n, xp = x.shape[1], x.data_ptr()
        scalar = G.select_plan(m, n, dtype, xp % width == 0).scalar
        records.append((xp, off * s, n, 0 if scalar else 1))
    flat = torch.empty(2 * total if fused else total, dtype=dtype, device=device)
    base = flat.data_ptr()
    dev = device.index if device.index is not None else torch.cuda.current_device()
    for start in range(0, len(records), G.MAX_LEAVES):
        chunk = records[start:start + G.MAX_LEAVES]
        arr = (ctypes.c_longlong * (5 * len(chunk)))()
        for i, (xp, off, n, vec) in enumerate(chunk):
            out2 = base + total * s + off if fused else 0
            arr[5 * i:5 * i + 5] = (xp, base + off, out2, n, vec)
        err = _build.launch_on(dev, lambda stream: fn(arr, len(chunk), stream))
        _build.check_launch(lib, kind, err)
        LAUNCHES[kind] += 1
        LEAVES[kind] += len(chunk)
    return flat


def _select_fake(kind: str, trim: int, xs: List[torch.Tensor]) -> torch.Tensor:
    """The op's fake implementation: the flat buffer's shape and dtype."""
    total = _layout(xs, xs[0].dtype, kind == FUSED)[3]
    return xs[0].new_empty(2 * total if kind == FUSED else total)


def launches_for(leaves: int) -> int:
    """Kernel launches one op call over ``leaves`` leaves makes."""
    return -(-leaves // G.MAX_LEAVES)


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("select(str kind, int trim, Tensor[] xs) -> Tensor")
_OPS.impl("select", _select_cuda, "CUDA")
torch.library.register_fake("repro_torch::select", _select_fake, lib=_OPS)
_SELECT = torch.ops.repro_torch.select.default


def median_many(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Coordinate-wise medians of leaves ``xs`` (each (m, n_i), one m, dtype
    and device) -> [(n_i,)], one launch per MAX_LEAVES leaves; the outputs
    are views of one flat buffer."""
    return _select_many("median", xs, 0)[0]


def trimmed_mean_many(xs: Sequence[torch.Tensor], trim: int) -> List[torch.Tensor]:
    """Coordinate-wise trimmed means of leaves ``xs`` over the ranks
    [trim, m - trim), as :func:`median_many`."""
    return _select_many("trimmed_mean", xs, trim)[0]


def fused_median_trimmed_many(xs: Sequence[torch.Tensor],
                              trim: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """([medians], [trimmed means]) of leaves ``xs``, each pair from one read
    of the leaf's rows, as :func:`median_many`."""
    meds, tms = _select_many(FUSED, xs, trim)
    return meds, tms


def median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of ``x`` (m, n) -> (n,), same dtype."""
    return median_many([x])[0]


def trimmed_mean(x: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean of ``x`` (m, n) -> (n,) over the ranks
    [trim, m - trim)."""
    return trimmed_mean_many([x], trim)[0]


def fused_median_trimmed(x: torch.Tensor, trim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(median, trimmed mean) of ``x`` (m, n) from one read of the rows."""
    meds, tms = fused_median_trimmed_many([x], trim)
    return meds[0], tms[0]
