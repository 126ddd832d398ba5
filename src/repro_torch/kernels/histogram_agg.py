"""Histogram-sketch math and the hand-written CUDA kernels of the
federated streaming sketch.

Sketch math (the reference's ``src/repro/kernels/histogram_agg.py:58-182``
in torch): equal-width per-coordinate bins over the f32 min/max range,
bin counts (and sums) by ``scatter_add``, and CDF inversion for the
median, nearest-rank quantiles and the trimmed mean.  Both estimators
are within one bin width ``(max - min) / nbins`` of the exact statistic.
The ``approx_*`` aggregators of :mod:`repro_torch.core.aggregators` use
:func:`sketch_array`.

Kernels (replacing the reference's Pallas TPU kernels):

==============================  =====================================
wrapper here                    TPU kernel replaced
==============================  =====================================
:func:`minmax`                  ``minmax_pallas`` (``_minmax_kernel``)
:func:`histogram`               ``histogram_pallas`` (``_hist_kernel``)
==============================  =====================================

Source: ``csrc/histogram_agg.cu`` (CUDA C++ for ``sm_90a``), built at
first use by :mod:`repro_torch.kernels.build` and loaded with ctypes; its
header says what bounds the kernels and what the design does about it.

Device rule: a CPU tensor takes the plain version (:func:`minmax_plain`,
:func:`histogram_plain`); a CUDA tensor launches the kernel or raises —
nothing falls back.  ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

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
    with _LOAD_LOCK:
        if _LIB is None:
            lib = _build.load(SOURCE, "hg_error_string", _build.BUILD_DIR)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.hg_minmax.argtypes = [p, i, ll, p, p, i, p]
            lib.hg_histogram.argtypes = [p, i, ll, p, p, i, p, p, i, p]
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
    order varies from run to run; :func:`histogram` does not."""
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
    ``(counts, sums, lo, width)``."""
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
# kernels and their plain versions
# --------------------------------------------------------------------------


def _check_chunk(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, n) chunk, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    rows, n = x.shape
    if not 1 <= rows < 2 ** 31:
        raise ValueError(f"the kernels take 1 <= rows < 2^31, got rows={rows}")
    if n < 1:
        raise ValueError("the kernels need at least one coordinate")
    if not x.is_contiguous():
        raise ValueError("the kernels need a contiguous (rows, n) chunk")
    if x.device.type not in ("cpu", "cuda"):
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
    if x.device.type == "cpu":
        return minmax_plain(x)
    lib = load()
    lo = torch.empty(x.shape[1], dtype=torch.float32, device=x.device)
    hi = torch.empty_like(lo)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hg_minmax(x.data_ptr(), x.shape[0], x.shape[1], lo.data_ptr(),
                            hi.data_ptr(), int(x.dtype == torch.bfloat16), stream)
    _build.check_launch(lib, "minmax", err)
    LAUNCHES["minmax"] += 1
    return lo, hi


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
    if x.device.type == "cpu":
        return histogram_plain(x, lo, width, nbins, with_sums)
    lib = load()
    counts = torch.empty((nbins, n), dtype=torch.float32, device=x.device)
    sums = torch.empty_like(counts) if with_sums else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hg_histogram(x.data_ptr(), x.shape[0], n, lo.data_ptr(), width.data_ptr(),
                               nbins, counts.data_ptr(),
                               None if sums is None else sums.data_ptr(),
                               int(x.dtype == torch.bfloat16), stream)
    _build.check_launch(lib, "histogram", err)
    LAUNCHES["histogram"] += 1
    return counts, sums
