"""Histogram-sketch math for the approximate aggregators.

The plain torch form of the reference's sketch helpers
(``src/repro/kernels/histogram_agg.py:58-182``): equal-width per-coordinate
bins over the f32 min/max range, bin counts (and sums) by
``scatter_add_``, and CDF inversion for the median, nearest-rank
quantiles and the trimmed mean.  Both estimators are within one bin width
``(max - min) / nbins`` of the exact statistic.

The reference's two Pallas kernels here (``minmax_pallas``,
``histogram_pallas``) carry the federated streaming path and are not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch


def bin_index(x: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, nbins: int) -> torch.Tensor:
    """Bin of each entry of ``x`` (..., d) given per-coordinate lo/width (d,).
    Zero-width coordinates map to bin 0."""
    safe_w = torch.where(width > 0, width, torch.ones_like(width))
    idx = torch.floor((x.float() - lo) / safe_w).to(torch.int64)
    return idx.clamp(0, nbins - 1)


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
    """Accumulate a ``(rows, d)`` chunk into the (nbins, d) sketch (new
    tensors; the inputs are not modified)."""
    idx = bin_index(chunk, lo, width, counts.shape[0])  # (rows, d)
    counts = counts.scatter_add(0, idx, torch.ones_like(idx, dtype=counts.dtype))
    if sums is not None:
        sums = sums.scatter_add(0, idx, chunk.float())
    return counts, sums


def sketch_array(x: torch.Tensor, nbins: int, with_sums: bool = True
                 ) -> tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Single-shot sketch of an in-memory ``(m, d)`` tensor:
    ``(counts, sums, lo, width)``."""
    xf = x.float()
    lo = xf.amin(dim=0)
    width = (xf.amax(dim=0) - lo) / nbins
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
    return contrib.sum(dim=0) / (m - 2 * b_trim)
