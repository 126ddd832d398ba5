"""Coordinate-wise robust aggregators (paper Definitions 1 and 2).

All functions aggregate a stack of per-worker tensors along dim 0: ``x``
has shape ``(m, ...)`` where ``m`` is the number of worker machines, and
the result lies on ``x``'s device.

For 2 <= m <= NETWORK_MAX_M the median and trimmed mean go through
:func:`repro_torch.kernels.ops.robust_aggregate`: the hand-written CUDA
kernel for CUDA tensors, the torch executor of the same comparator
program for CPU tensors.  :func:`tree_aggregate` groups a tree's leaves
so that each group takes one kernel call over all its leaves.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import histogram_agg as H
from repro_torch.kernels import ops, robust_agg
from repro_torch.kernels.selection_network import NETWORK_MAX_M
from repro_torch.tree import tree_leaves, tree_map

AggFn = Callable[[torch.Tensor], torch.Tensor]


def coordinate_mean(x: torch.Tensor) -> torch.Tensor:
    """Plain mean over the worker axis (the non-robust baseline)."""
    return x.mean(dim=0)


def _trimmed_mean_topk(x: torch.Tensor, b: int) -> torch.Tensor:
    """beta-trimmed mean via partial selection: ``torch.topk`` finds the
    b-th smallest/largest values, which bound the kept band; the band is
    summed through a keep-mask, with tie corrections at the two
    thresholds so exactly m - 2b entries contribute.

    Only the kept band is summed: ``total - top_b - bottom_b`` cancels
    catastrophically when the trimmed rows are Byzantine-scale (±1e30
    outliers wipe out the honest contribution to ``total`` in f32).
    """
    m = x.shape[0]
    xf = torch.movedim(x.float(), 0, -1)  # (..., m)
    hi_thr = torch.topk(xf, b, dim=-1).values[..., -1]    # b-th largest
    lo_thr = -torch.topk(-xf, b, dim=-1).values[..., -1]  # b-th smallest
    lo = lo_thr[..., None]
    hi = hi_thr[..., None]
    mid_sum = torch.where((xf > lo) & (xf < hi), xf, torch.zeros_like(xf)).sum(dim=-1)
    # Ties at a threshold: of the entries equal to lo_thr, (b - #below)
    # are trimmed and the rest kept; symmetrically at hi_thr.
    kept_lo = (xf == lo).sum(dim=-1) - (b - (xf < lo).sum(dim=-1))
    kept_hi = (xf == hi).sum(dim=-1) - (b - (xf > hi).sum(dim=-1))
    zero = torch.zeros_like(lo_thr)
    band_sum = (mid_sum
                + torch.where(kept_lo > 0, lo_thr * kept_lo, zero)
                + torch.where(kept_hi > 0, hi_thr * kept_hi, zero))
    # lo_thr == hi_thr: the whole kept band is that one value
    band_sum = torch.where(lo_thr == hi_thr, (m - 2 * b) * lo_thr, band_sum)
    return (band_sum / (m - 2 * b)).to(x.dtype)


def coordinate_median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the worker axis (paper Definition 1).

    For even ``m`` the f32 average of the two middle order statistics.
    Small m dispatches through the selection network / CUDA kernel;
    larger m uses the full sort.
    """
    m = x.shape[0]
    if 2 <= m <= NETWORK_MAX_M:
        return ops.robust_aggregate(x, "median")
    s = torch.sort(x, dim=0).values
    if m % 2 == 1:
        return s[m // 2]
    # Average in f32 to avoid bf16 midpoint artifacts, cast back.
    return ((s[m // 2 - 1].float() + s[m // 2].float()) * 0.5).to(x.dtype)


def coordinate_trimmed_mean(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Coordinate-wise beta-trimmed mean (paper Definition 2).

    Removes the largest and smallest ``floor(beta * m)`` entries per
    coordinate and averages the rest; ``beta`` must be in [0, 1/2).
    Dispatch: selection network / CUDA kernel for small m; ``torch.topk``
    partial selection for large m with b <= m/8; full sort otherwise.
    """
    if not 0.0 <= beta < 0.5:
        raise ValueError(f"beta must be in [0, 1/2), got {beta}")
    m = x.shape[0]
    b = int(beta * m)
    if 2 * b >= m:
        raise ValueError(f"trim count 2*{b} >= m={m}")
    if b == 0:
        return coordinate_mean(x)
    if m <= NETWORK_MAX_M:
        return ops.robust_aggregate(x, "trimmed_mean", beta=beta)
    if b <= m // 8:
        return _trimmed_mean_topk(x, b)
    kept = torch.sort(x, dim=0).values[b: m - b]
    return kept.float().mean(dim=0).to(x.dtype)


def coordinate_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Coordinate-wise empirical q-quantile over the worker axis
    (nearest rank ``round(q * (m - 1))``, Python's rounding, no
    interpolation)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    m = x.shape[0]
    idx = min(m - 1, int(round(q * (m - 1))))
    return torch.sort(x, dim=0).values[idx]


def geometric_median(x: torch.Tensor, iters: int = 8, eps: float = 1e-6) -> torch.Tensor:
    """Geometric median over the worker axis via Weiszfeld iterations
    (rotation-equivariant vector median; gather-only)."""
    xf = x.reshape(x.shape[0], -1).float()
    y = xf.mean(dim=0)
    for _ in range(iters):
        d = torch.linalg.vector_norm(xf - y[None, :], dim=1)
        w = 1.0 / d.clamp(min=eps)
        y = (w[:, None] * xf).sum(dim=0) / w.sum()
    return y.reshape(x.shape[1:]).to(x.dtype)


def krum(x: torch.Tensor, num_byzantine: int = 0, multi: int = 1) -> torch.Tensor:
    """Krum / multi-Krum (Blanchard et al., 2017): score each worker by the
    sum of squared distances to its m - q - 2 nearest neighbours and
    return the best row (multi-Krum: the mean of the ``multi`` best)."""
    m = x.shape[0]
    q = min(num_byzantine, max(0, (m - 3) // 2))
    k = max(1, m - q - 2)
    flat = x.reshape(m, -1).float()
    sq = (flat * flat).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)  # (m, m)
    d2 = d2 + torch.diag(torch.full((m,), float("inf"), device=x.device))
    scores = -torch.topk(-d2, k, dim=1).values.sum(dim=1)
    best = torch.topk(-scores, min(multi, m)).indices
    return flat[best].mean(dim=0).reshape(x.shape[1:]).to(x.dtype)


def approx_coordinate_median(x: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Histogram-sketch approximation of the coordinate-wise median; error
    <= one bin width ``(max - min) / nbins`` per coordinate."""
    m = x.shape[0]
    counts, _, lo, width = H.sketch_array(x.reshape(m, -1), nbins, with_sums=False)
    out = H.median_from_hist(counts, lo, width, m)
    return out.reshape(x.shape[1:]).to(x.dtype)


def approx_coordinate_trimmed_mean(x: torch.Tensor, beta: float, nbins: int = 256) -> torch.Tensor:
    """Histogram-sketch approximation of the beta-trimmed mean (same sketch
    as :func:`approx_coordinate_median`; error <= one bin width)."""
    m = x.shape[0]
    counts, sums, lo, width = H.sketch_array(x.reshape(m, -1), nbins)
    out = H.trimmed_mean_from_hist(counts, sums, lo, width, m, beta)
    return out.reshape(x.shape[1:]).to(x.dtype)


# --------------------------------------------------------------- registry
#
# Same names, ``exact`` flags and breakdown strings as the reference's
# registry.  ``make(beta)`` builds the aggregation function.


@dataclasses.dataclass(frozen=True)
class AggregatorSpec:
    """A registered aggregator: factory + documented properties."""

    name: str
    make: Callable[[float], AggFn]  # beta -> aggregation fn
    exact: bool  # exact order statistics vs sketch/iterative approximation
    breakdown: str  # breakdown point, human-readable
    summary: str = ""


_AGGREGATORS: Dict[str, AggregatorSpec] = {}


def register_aggregator(spec: AggregatorSpec) -> AggregatorSpec:
    if spec.name in _AGGREGATORS:
        raise ValueError(f"aggregator {spec.name!r} already registered")
    _AGGREGATORS[spec.name] = spec
    return spec


def get_aggregator_spec(name: str) -> AggregatorSpec:
    try:
        return _AGGREGATORS[name]
    except KeyError:
        raise ValueError(f"unknown aggregation method: {name!r}") from None


def registered_aggregators() -> Tuple[str, ...]:
    """Registered aggregator names, registration order."""
    return tuple(_AGGREGATORS)


register_aggregator(AggregatorSpec(
    "mean", lambda beta: coordinate_mean, exact=True, breakdown="0",
    summary="plain average — the non-robust baseline"))
register_aggregator(AggregatorSpec(
    "median", lambda beta: coordinate_median, exact=True, breakdown="1/2",
    summary="coordinate-wise median (paper Definition 1)"))
register_aggregator(AggregatorSpec(
    "trimmed_mean",
    lambda beta: functools.partial(coordinate_trimmed_mean, beta=beta),
    exact=True, breakdown="β",
    summary="coordinate-wise β-trimmed mean (paper Definition 2)"))
register_aggregator(AggregatorSpec(
    "approx_median", lambda beta: approx_coordinate_median,
    exact=False, breakdown="1/2",
    summary="histogram-sketch median, error ≤ one bin width (fed/chunked)"))
register_aggregator(AggregatorSpec(
    "approx_trimmed_mean",
    lambda beta: functools.partial(approx_coordinate_trimmed_mean, beta=beta),
    exact=False, breakdown="β",
    summary="histogram-sketch β-trimmed mean, error ≤ one bin width"))
register_aggregator(AggregatorSpec(
    "geometric_median", lambda beta: geometric_median,
    exact=False, breakdown="1/2",
    summary="Weiszfeld vector median (Minsker 2015); gather-only"))
register_aggregator(AggregatorSpec(
    "krum",
    # beta doubles as the declared Byzantine fraction for Krum
    lambda beta: lambda x: krum(x, num_byzantine=int(beta * x.shape[0])),
    exact=True, breakdown="(m−2)/2m",
    summary="Krum selection rule (Blanchard et al. 2017); gather-only"))
register_aggregator(AggregatorSpec(
    "multi_krum",
    lambda beta: lambda x: krum(x, num_byzantine=int(beta * x.shape[0]),
                                multi=max(1, x.shape[0] // 2)),
    exact=True, breakdown="(m−2)/2m",
    summary="multi-Krum: average of the m/2 best-scored rows; gather-only"))


def get_aggregator(method: str, beta: float = 0.1) -> AggFn:
    """Return an aggregation function ``(m, ...) -> (...)`` by name (see
    :func:`registered_aggregators`)."""
    return get_aggregator_spec(method).make(beta)


@trace.spanned("aggregate.select")
def aggregate_leaves(leaves, method: str, beta: float = 0.1) -> list:
    """Aggregate each (m, ...) leaf with ``method``; equal, leaf for leaf, to
    ``[get_aggregator(method, beta)(x) for x in leaves]``.

    The median, and the trimmed mean with a trim of at least 1, over
    2 <= m <= NETWORK_MAX_M rows of float32 / bfloat16 / float16 leaves with
    at least one coordinate take one call of :func:`robust_agg.median_many` /
    :func:`robust_agg.trimmed_mean_many` per (m, dtype, device) group: on the
    card one kernel launch covers the group's leaves; on the CPU that call
    runs the plain version leaf by leaf, which is what the per-leaf path runs
    too.  Other leaves (float64, zero-width) take the per-leaf path, whose
    route :func:`repro_torch.kernels.ops.auto_backend` states."""
    agg = get_aggregator(method, beta)
    out = [None] * len(leaves)
    groups: Dict[tuple, list] = {}
    if method == "median" or (method == "trimmed_mean" and 0.0 <= beta < 0.5):
        for i, x in enumerate(leaves):
            m = x.shape[0] if x.dim() else 0
            trim = int(beta * m) if method == "trimmed_mean" else 0
            if (2 <= m <= NETWORK_MAX_M and x.numel() > 0
                    and x.dtype in robust_agg.DTYPES
                    and x.device.type in ("cpu", "cuda")
                    and (method == "median" or 1 <= trim and 2 * trim < m)):
                groups.setdefault((m, trim, x.dtype, x.device), []).append(i)
    for (m, trim, _, _), idx in groups.items():
        flats = [leaves[i] if leaves[i].dim() == 2 else leaves[i].reshape(m, -1)
                 for i in idx]
        flats = [x.contiguous() for x in flats]
        if method == "median":
            res = robust_agg.median_many(flats)
        else:
            res = robust_agg.trimmed_mean_many(flats, trim)
        for i, r in zip(idx, res):
            out[i] = r if leaves[i].dim() == 2 else r.view(leaves[i].shape[1:])
    return [agg(x) if r is None else r for x, r in zip(leaves, out)]


def tree_aggregate(grads_stacked, method: str, beta: float = 0.1):
    """Apply an aggregator leaf-wise to a dict/tuple tree of per-worker
    stacked gradients (each leaf has leading worker axis m), grouping the
    leaves as :func:`aggregate_leaves` does."""
    results = iter(aggregate_leaves(tree_leaves(grads_stacked), method, beta))
    return tree_map(lambda _: next(results), grads_stacked)
