"""Histogram-sketch math and the hand-written CUDA kernels of the
federated streaming sketch.

Sketch math (the reference's ``src/repro/kernels/histogram_agg.py:58-182``
in torch): equal-width per-coordinate bins over the f32 min/max range,
bin counts (and sums), and CDF inversion for the median, nearest-rank
quantiles and the trimmed mean.  Both estimators are within one bin width
``(max - min) / nbins`` of the exact statistic.  The ``approx_*``
aggregators of :mod:`repro_torch.core.aggregators` use
:func:`sketch_array`, which goes through the kernels on a CUDA tensor (so
its sums are added in row order, the same on every run) and through a
``scatter_add`` on a CPU tensor.

Kernels (replacing the reference's Pallas TPU kernels):

==============================  =====================================
wrapper here                    TPU kernel replaced
==============================  =====================================
:func:`minmax`                  ``minmax_pallas`` (``_minmax_kernel``)
:func:`histogram`               ``histogram_pallas`` (``_hist_kernel``)
==============================  =====================================

Source: ``csrc/histogram_agg.cu`` (CUDA C++ for ``sm_90a``), built at
first use by :mod:`repro_torch.kernels.build` and loaded with ctypes; its
header says what bounds the kernels and how they are laid out.  In short:
min/max splits each column tile's rows across the warps of a block (16-byte
loads where the data allow) and combines the warps' results in a fixed
order; the histogram keeps a privatized ``[bin][column]`` tile of counts
and sums in shared memory, adds every (bin, column) in row order and
flushes the tile once.  The launch plan of both is chosen here, by
:func:`minmax_plan` and :func:`histogram_plan`, so that a CPU test can pin
it.

Device rule: a CPU tensor takes the plain version (:func:`minmax_plain`,
:func:`histogram_plain`); a CUDA tensor launches the kernel or raises —
nothing falls back; a meta tensor (a dry-run's stand-in) gets the
outputs' shapes.  ``LAUNCHES`` counts kernel launches per wrapper.  A
CUDA call goes through a dispatcher op (``torch.ops.repro_torch.minmax``,
``torch.ops.repro_torch.histogram``) whose CUDA implementation is the
ctypes launch and whose fake implementation returns the outputs' shapes
and dtypes and builds nothing (a dry-run's fake or meta tensors pass
through it).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import takes_kernels
from repro_torch.kernels import build as _build
from repro_torch.kernels import selection_network as SN

SOURCE = _build.CSRC / "histogram_agg.cu"

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"minmax": 0, "histogram": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    """Compile the kernels (once per source content) and return the shared
    library's path; nvcc's ``-Xptxas -v`` report goes to a ``.log`` file
    beside it."""
    return _build.build(SOURCE, _build.BUILD_DIR)


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call).  Raises when CUDA
    or nvcc is missing."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = _build.load(SOURCE, "hg_error_string", _build.BUILD_DIR)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.hg_minmax.argtypes = [p, i, ll, p, p, i, i, i, p]
            lib.hg_histogram.argtypes = [p, i, ll, p, p, i, p, p, i, i, i, i, i, p]
            lib.hg_minmax.restype = lib.hg_histogram.restype = ctypes.c_int
            _LIB = lib
    return _LIB


# --------------------------------------------------------------------------
# sketch math
# --------------------------------------------------------------------------


def bin_index(x: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, nbins: int) -> torch.Tensor:
    """Bin of each entry of ``x`` (..., d) given per-coordinate lo/width (d,),
    as the histogram kernel computes it: f32 ``floor((x - lo) / safe_w)``
    clipped in float to [0, nbins - 1] before the integer conversion, so
    ±inf quotients land in the end bins and NaN in bin 0.  Zero-width
    coordinates map to bin 0."""
    safe_w = torch.where(width > 0, width, torch.ones_like(width))
    q = torch.floor((x.float() - lo) / safe_w)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q.clamp(0, nbins - 1))
    return q.to(torch.int64)


def hist_init(d: int, nbins: int, with_sums: bool = True, *, device="cuda"
              ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Empty sketch state: (counts, sums), each (nbins, d) f32;
    ``with_sums=False`` returns ``(counts, None)``."""
    counts = torch.zeros((nbins, d), dtype=torch.float32, device=device)
    return counts, (torch.zeros_like(counts) if with_sums else None)


def hist_update(
    counts: torch.Tensor,
    sums: Optional[torch.Tensor],
    chunk: torch.Tensor,
    lo: torch.Tensor,
    width: torch.Tensor,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Accumulate a ``(rows, d)`` chunk into the (nbins, d) sketch with one
    ``scatter_add`` over the chunk (new tensors; the inputs are not
    modified).  On CUDA the sums' scatter uses atomics, so their rounding
    order varies from run to run: the card's callers take :func:`histogram`
    instead."""
    idx = bin_index(chunk, lo, width, counts.shape[0])  # (rows, d)
    counts = counts.scatter_add(0, idx, torch.ones_like(idx, dtype=counts.dtype))
    if sums is not None:
        sums = sums.scatter_add(0, idx, chunk.float())
    return counts, sums


def edges(lo: torch.Tensor, hi: torch.Tensor, nbins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, width) of the equal-width binning; width 0 on degenerate
    coordinates.  The divisor is a full tensor, so this is a true IEEE
    division on every device (CUDA's division by a host scalar multiplies
    by the reciprocal, 1 ulp off for nbins that is not a power of two)."""
    return lo, (hi - lo) / torch.full_like(lo, nbins)


def sketch_array(x: torch.Tensor, nbins: int, with_sums: bool = True
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Single-shot sketch of an in-memory ``(m, d)`` tensor:
    ``(counts, sums, lo, width)``.  A CUDA tensor goes through the kernels
    (:func:`minmax`, then :func:`histogram`), whose sums are added in row
    order, so the result is the same on every run; a CPU tensor through
    ``amin``/``amax`` and :func:`hist_update`."""
    if takes_kernels(x):
        xk = (x if x.dtype in _KERNEL_DTYPES else x.float()).contiguous()
        lo, width = edges(*minmax(xk), nbins)
        counts, sums = histogram(xk, lo, width, nbins, with_sums)
        return counts, sums, lo, width
    xf = x.float()
    lo, width = edges(xf.amin(dim=0), xf.amax(dim=0), nbins)
    counts, sums = hist_update(
        *hist_init(x.shape[-1], nbins, with_sums=with_sums, device=x.device),
        x, lo, width)
    return counts, sums, lo, width


def _value_at_rank(counts: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, rank) -> torch.Tensor:
    """Centre of the bin holding the rank-th smallest element (1-indexed)."""
    nbins = counts.shape[0]
    cum = torch.cumsum(counts, dim=0)  # (nbins, d)
    b = (cum < float(rank)).sum(dim=0).clamp(0, nbins - 1)
    return lo + (b.float() + 0.5) * width


def median_from_hist(counts: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, m: int) -> torch.Tensor:
    """Approximate coordinate-wise median from the sketch; error <= width.
    For even m the two middle order statistics are located independently
    and averaged."""
    if m % 2 == 1:
        return _value_at_rank(counts, lo, width, (m + 1) // 2)
    a = _value_at_rank(counts, lo, width, m // 2)
    b = _value_at_rank(counts, lo, width, m // 2 + 1)
    return 0.5 * (a + b)


def quantile_from_hist(counts: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, m: int, q: float) -> torch.Tensor:
    """Approximate nearest-rank q-quantile."""
    rank = min(m, max(1, int(round(q * (m - 1))) + 1))
    return _value_at_rank(counts, lo, width, rank)


def trimmed_mean_from_hist(
    counts: torch.Tensor,
    sums: torch.Tensor,
    lo: torch.Tensor,
    width: torch.Tensor,
    m: int,
    beta: float,
) -> torch.Tensor:
    """Approximate coordinate-wise beta-trimmed mean from the sketch: a bin
    entirely inside the kept ranks (b_trim, m - b_trim] contributes its
    exact sum, a straddling bin ``overlap * centre``."""
    if not 0.0 <= beta < 0.5:
        raise ValueError(f"beta must be in [0, 1/2), got {beta}")
    b_trim = int(beta * m)
    if 2 * b_trim >= m:
        raise ValueError(f"trim count 2*{b_trim} >= m={m}")
    nbins = counts.shape[0]
    cum = torch.cumsum(counts, dim=0)  # (nbins, d)
    prev = cum - counts
    kept = (cum.clamp(max=m - b_trim) - prev.clamp(min=b_trim)).clamp(min=0.0)
    bins = torch.arange(nbins, dtype=torch.float32, device=counts.device)[:, None]
    centres = lo[None, :] + (bins + 0.5) * width[None, :]
    whole = (kept == counts) & (counts > 0)
    contrib = torch.where(whole, sums, kept * centres)
    total = contrib.sum(dim=0)
    return total / torch.full_like(total, m - 2 * b_trim)


# --------------------------------------------------------------------------
# launch plans (passed to the CUDA entry points, which reject a plan that
# the data cannot take)
# --------------------------------------------------------------------------

#: dynamic shared memory one block can use on an H100 (bytes)
SMEM_LIMIT = 232_448
#: streaming multiprocessors of an H100 SXM
NUM_SMS = 132
#: rows a histogram walker takes at a time (``kGroup`` in the source): the
#: fewest staged rows a one-column tile must hold
MIN_STAGE_ROWS = 8
#: chunks of more rows take the global histogram: the shared one counts in
#: int, which equals the plain version's f32 +1 chain up to 2^24
MAX_SHARED_ROWS = 1 << 24
#: rows a histogram thread loads per staged batch, at most (``kLoads``)
LOADS_PER_THREAD = 8
_MAX_HIST_THREADS = 512
_WIDE_HIST_THREADS = 128
_MAX_TILE = 32
_MAX_STAGE_ROWS = 512


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    return 1 << (max(1, v) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class MinmaxPlan:
    """``vec`` columns per lane (1, or 16 bytes' worth: 4 f32 / 8 bf16) and
    ``warps`` warps that split a tile's rows; a block owns ``32 * vec``
    columns."""

    vec: int
    warps: int

    @property
    def tile(self) -> int:
        return 32 * self.vec

    @property
    def smem_bytes(self) -> int:  # the warps' partial min and max
        return 2 * self.warps * self.tile * 4


@functools.lru_cache(maxsize=1024)
def minmax_plan(rows: int, n: int, elem_size: int, aligned16: bool) -> MinmaxPlan:
    """16-byte loads only where the pointer is 16-byte aligned, ``n`` is a
    multiple of the vector (so every row starts aligned) and there are at
    least as many vector tiles as SMs; about 16 rows a warp, at most 32
    warps (16 with 8-wide bf16 vectors, whose registers allow 512
    threads)."""
    vec = 16 // elem_size
    if not (aligned16 and n % vec == 0 and n >= 32 * vec * NUM_SMS):
        vec = 1
    return MinmaxPlan(vec, max(1, min(rows // 16, 16 if vec == 8 else 32)))


def minmax_plan_for(x: torch.Tensor) -> MinmaxPlan:
    """:func:`minmax_plan` for a ``(rows, n)`` chunk, from its data pointer."""
    rows, n = x.shape
    return minmax_plan(rows, n, x.element_size(), x.data_ptr() % 16 == 0)


@dataclasses.dataclass(frozen=True)
class HistogramPlan:
    """The shared variant: blocks of ``threads`` threads, each owning
    ``tile`` columns (a power of two) and staging ``stage_rows`` rows at a
    time in ``smem_bytes`` of shared memory.  ``smem_bytes == 0`` is the
    global variant."""

    tile: int = 0
    threads: int = 0
    stage_rows: int = 0
    smem_bytes: int = 0

    @property
    def shared(self) -> bool:
        return self.smem_bytes > 0

    @property
    def log2_tile(self) -> int:
        return max(0, self.tile.bit_length() - 1)


def histogram_smem_bytes(nbins: int, with_sums: bool, tile: int, stage_rows: int) -> int:
    """Shared memory of the shared variant: per column of the tile, an int
    count for each of ``nbins`` bins; with sums also an f32 sum per bin and
    a staged bin and value per row of a batch of ``stage_rows``."""
    return (8 * (nbins + stage_rows) if with_sums else 4 * nbins) * tile


@functools.lru_cache(maxsize=1024)
def histogram_plan(rows: int, n: int, nbins: int, with_sums: bool) -> HistogramPlan:
    """The global variant exactly when one column's histogram, with
    ``MIN_STAGE_ROWS`` staged rows, exceeds :data:`SMEM_LIMIT`, or when
    ``rows > MAX_SHARED_ROWS``.  Otherwise a tile of about ``n / NUM_SMS``
    columns (8 to 32, a power of two), halved until it fits half the limit
    (two blocks an SM) or else the whole limit; then as many staged rows as
    fit (a power of two, up to 512, and at most ``LOADS_PER_THREAD`` for
    each thread).  Blocks have up to 512 threads when there are fewer
    blocks than SMs (the federated chunk: 4 blocks, all 512 rows staged
    at once), else up to 128: on an H100 at 256 x 2^20 x 128 bins, tiles
    of 32 columns in blocks of 128 threads (five blocks an SM with sums)
    beat tiles of 16 to 128 columns in blocks of 256 or 512 threads, and
    16 or 32 rows a thread, with and without sums, f32 and bf16."""
    if (histogram_smem_bytes(nbins, with_sums, 1, MIN_STAGE_ROWS) > SMEM_LIMIT
            or rows > MAX_SHARED_ROWS):
        return HistogramPlan()
    stage_cap = min(_MAX_STAGE_ROWS, _pow2_ceil(rows))
    least = min(stage_cap, MIN_STAGE_ROWS)
    tile = min(_MAX_TILE, _pow2_floor(max(8, n // NUM_SMS)), _pow2_ceil(n))
    for budget in (SMEM_LIMIT // 2, SMEM_LIMIT):
        t = tile
        while t > 1 and histogram_smem_bytes(nbins, with_sums, t, least) > budget:
            t //= 2
        if histogram_smem_bytes(nbins, with_sums, t, least) <= budget:
            break
    # few blocks: big ones, the whole chunk in flight at once; many: small ones
    most = _MAX_HIST_THREADS if -(-n // t) < NUM_SMS else _WIDE_HIST_THREADS
    stage = min(stage_cap, most * LOADS_PER_THREAD // t)
    while stage > least and histogram_smem_bytes(nbins, with_sums, t, stage) > budget:
        stage //= 2
    return HistogramPlan(tile=t, threads=min(most, max(32, t * stage)), stage_rows=stage,
                         smem_bytes=histogram_smem_bytes(nbins, with_sums, t, stage))


# --------------------------------------------------------------------------
# kernels and their plain versions
# --------------------------------------------------------------------------


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_chunk(x: torch.Tensor) -> None:
    """Raise unless ``x`` is a chunk the kernels take: a contiguous (rows, n)
    f32 or bf16 tensor on the CPU or a CUDA card, 1 <= rows < 2^31, n >= 1.
    The common case is checked first: on the sketch's small chunks the
    wrapper's host time is most of a call."""
    if x.dim() == 2 and x.dtype in _KERNEL_DTYPES and x.is_contiguous() \
            and (takes_kernels(x) or x.is_cpu):
        rows, n = x.shape
        if 1 <= rows < 2 ** 31 and n >= 1:
            return
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, n) chunk, got shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    rows, n = x.shape
    if not 1 <= rows < 2 ** 31:
        raise ValueError(f"the kernels take 1 <= rows < 2^31, got rows={rows}")
    if n < 1:
        raise ValueError("the kernels need at least one coordinate")
    if not x.is_contiguous():
        raise ValueError("the kernels need a contiguous (rows, n) chunk")
    raise ValueError(f"unsupported device {x.device}")


def minmax_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`minmax`: rows reduced in order with
    ``jnp.minimum``/``jnp.maximum`` semantics (NaN propagates, -0 < +0)."""
    xf = x.float()
    lo = hi = xf[0]
    for r in range(1, xf.shape[0]):
        lo = SN.ieee_minimum(lo, xf[r])
        hi = SN.ieee_maximum(hi, xf[r])
    return lo.clone(), hi.clone()


def minmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-coordinate f32 (min, max) of a ``(rows, n)`` chunk -> two (n,)."""
    _check_chunk(x)
    if not takes_kernels(x):
        return minmax_plain(x)
    return _MINMAX(x)


def _minmax_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op's CUDA implementation: one launch on the (checked) chunk."""
    lib = load()
    rows, n = x.shape
    plan = minmax_plan_for(x)
    lo = x.new_empty(n, dtype=torch.float32)
    hi = torch.empty_like(lo)
    err = _build.launch_on(x.get_device(), lambda stream: lib.hg_minmax(
        x.data_ptr(), rows, n, lo.data_ptr(), hi.data_ptr(), int(x.dtype == torch.bfloat16),
        plan.vec, plan.warps, stream))
    _build.check_launch(lib, "minmax", err)
    LAUNCHES["minmax"] += 1
    return lo, hi


def _minmax_fake(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = x.new_empty(x.shape[1], dtype=torch.float32)
    return lo, torch.empty_like(lo)


def histogram_plain(x: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, nbins: int,
                    with_sums: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of :func:`histogram`: one ``scatter_add_`` per row
    into fresh zero tensors.  Within a row every column is distinct, so no
    two additions meet and the sums are added in row order, as the kernel
    adds them."""
    rows, n = x.shape
    idx = bin_index(x, lo, width, nbins)
    xf = x.float()
    counts = torch.zeros((nbins, n), dtype=torch.float32, device=x.device)
    sums = torch.zeros_like(counts) if with_sums else None
    one = torch.ones((1, n), dtype=torch.float32, device=x.device)
    for r in range(rows):
        counts.scatter_add_(0, idx[r:r + 1], one)
        if sums is not None:
            sums.scatter_add_(0, idx[r:r + 1], xf[r:r + 1])
    return counts, sums


def histogram(x: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, nbins: int,
              with_sums: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-chunk bin counts and sums of ``x`` (rows, n) -> two (nbins, n) f32
    (sums None when ``with_sums=False``): the chunk's increments, to be
    added to a running sketch."""
    _check_chunk(x)
    n = x.shape[1]
    for name, t in (("lo", lo), ("width", width)):
        if t.shape != (n,) or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not 1 <= nbins < 2 ** 31:
        raise ValueError(f"nbins must be >= 1, got {nbins}")
    if not takes_kernels(x):
        return histogram_plain(x, lo, width, nbins, with_sums)
    out = _HISTOGRAM(x, lo, width, nbins, with_sums)
    return out[0], (out[1] if with_sums else None)


def _histogram_cuda(x: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, nbins: int,
                    with_sums: bool) -> List[torch.Tensor]:
    """The op's CUDA implementation: one launch on the (checked) chunk ->
    [counts] or [counts, sums]."""
    lib = load()
    n = x.shape[1]
    plan = histogram_plan(x.shape[0], n, nbins, with_sums)
    counts = x.new_empty((nbins, n), dtype=torch.float32)
    sums = torch.empty_like(counts) if with_sums else None
    err = _build.launch_on(x.get_device(), lambda stream: lib.hg_histogram(
        x.data_ptr(), x.shape[0], n, lo.data_ptr(), width.data_ptr(), nbins, counts.data_ptr(),
        None if sums is None else sums.data_ptr(), int(x.dtype == torch.bfloat16),
        plan.log2_tile, plan.threads, plan.stage_rows, plan.smem_bytes, stream))
    _build.check_launch(lib, "histogram", err)
    LAUNCHES["histogram"] += 1
    return [counts] if sums is None else [counts, sums]


def _histogram_fake(x, lo, width, nbins: int, with_sums: bool) -> List[torch.Tensor]:
    counts = x.new_empty((nbins, x.shape[1]), dtype=torch.float32)
    return [counts, torch.empty_like(counts)] if with_sums else [counts]


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("minmax(Tensor x) -> (Tensor, Tensor)")
_OPS.define("histogram(Tensor x, Tensor lo, Tensor width, int nbins, bool with_sums) "
            "-> Tensor[]")
_OPS.impl("minmax", _minmax_cuda, "CUDA")
_OPS.impl("histogram", _histogram_cuda, "CUDA")
torch.library.register_fake("repro_torch::minmax", _minmax_fake, lib=_OPS)
torch.library.register_fake("repro_torch::histogram", _histogram_fake, lib=_OPS)
_MINMAX = torch.ops.repro_torch.minmax.default
_HISTOGRAM = torch.ops.repro_torch.histogram.default
