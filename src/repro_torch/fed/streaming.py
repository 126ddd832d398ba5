"""Streaming chunked robust aggregation (two-pass histogram sketch).

``streaming_aggregate`` consumes a cohort of m gradient rows as a
sequence of fixed-size chunks produced by ``chunk_fn(j) -> (rows_j, d)``
and returns the approximate coordinate-wise median / β-trimmed mean
without ever materializing the ``(m, d)`` matrix.  ``chunk_fn`` is called
twice per chunk (pass 1: min/max; pass 2: bin counts), the deliberate
trade: chunks are *regenerated* (virtual clients are seed-derived, see
:mod:`repro_torch.fed.population`) instead of cached (O(m·d) memory).

Estimator: per-coordinate equal-width histogram over [min, max] with
``nbins`` bins; CDF inversion gives order statistics within one bin
width ``(max − min) / nbins`` of the exact values.

Kernels: every chunk goes through
:func:`~repro_torch.kernels.histogram_agg.minmax` and
:func:`~repro_torch.kernels.histogram_agg.histogram`, which launch the
CUDA kernels on a CUDA chunk and run their plain versions on a CPU chunk
(the wrappers' device rule; nothing else picks the path).  The sums are
added in row order, the counts are integers (exact in any order), and
nothing adds floats atomically, so a run is bitwise repeatable.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve
from repro_torch.kernels import histogram_agg as H
from repro_torch.kernels.selection_network import ieee_maximum, ieee_minimum


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    nbins: int = 256


# ------------------------------------------------------------------ pass 1


def minmax_init(d: int, *, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    lo = torch.full((d,), float("inf"), dtype=torch.float32, device=resolve(device))
    return lo, torch.full_like(lo, float("-inf"))


def minmax_update(state, chunk: torch.Tensor):
    lo, hi = state
    clo, chi = H.minmax(chunk.contiguous())
    return ieee_minimum(lo, clo), ieee_maximum(hi, chi)


def edges_from_minmax(state, nbins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, width) of the equal-width binning; width 0 on degenerate coords."""
    return H.edges(*state, nbins)


# ------------------------------------------------------------------ pass 2


def hist_update(state, chunk: torch.Tensor, lo: torch.Tensor, width: torch.Tensor):
    counts, sums = state
    dc, ds = H.histogram(chunk.contiguous(), lo, width, counts.shape[0],
                         with_sums=sums is not None)
    return counts + dc, (sums + ds if sums is not None else None)


# ----------------------------------------------------------------- drivers


def streaming_aggregate(
    chunk_fn: Callable[[int], torch.Tensor],
    num_chunks: int,
    d: int,
    method: str = "median",
    beta: float = 0.1,
    cfg: SketchConfig = SketchConfig(),
) -> torch.Tensor:
    """Aggregate a chunked stream of gradient rows; returns (d,) f32 on
    the chunks' device.

    ``chunk_fn(j)`` must return the j-th ``(rows_j, d)`` chunk and be
    deterministic — it is called once per pass.  ``method`` is ``median``,
    ``trimmed_mean`` or ``mean`` (a running sum, for baselines).
    """
    return streaming_aggregate_multi(
        chunk_fn, num_chunks, d, (method,), beta, cfg)[method]


def streaming_aggregate_multi(
    chunk_fn: Callable[[int], torch.Tensor],
    num_chunks: int,
    d: int,
    methods: tuple = ("median", "trimmed_mean"),
    beta: float = 0.1,
    cfg: SketchConfig = SketchConfig(),
) -> dict:
    """Several estimators from ONE shared sketch; returns {method: (d,)} on
    the chunks' device.  The median alone needs no bin sums, so its pass 2
    writes counts only; ``mean`` rides along on the pass-1 stream."""
    methods = tuple(methods)
    unknown = [mt for mt in methods if mt not in ("mean", "median", "trimmed_mean")]
    if unknown:
        raise ValueError(f"unknown streaming method(s) {unknown!r}")
    if num_chunks < 1:
        raise ValueError("the stream needs at least one chunk")
    out = {}
    need_sketch = [mt for mt in methods if mt != "mean"]
    m = 0
    for j in range(num_chunks):
        c = chunk_fn(j)
        if j == 0:  # the running state lives where the chunks do
            device = c.device
            total = (torch.zeros((d,), dtype=torch.float32, device=device)
                     if "mean" in methods else None)
            mm = minmax_init(d, device=device) if need_sketch else None
        m += c.shape[0]
        if total is not None:
            total = total + c.float().sum(dim=0)
        if mm is not None:
            mm = minmax_update(mm, c)
    if total is not None:
        out["mean"] = total / torch.full_like(total, m)
    if not need_sketch:
        return out
    lo, width = edges_from_minmax(mm, cfg.nbins)

    hist = H.hist_init(d, cfg.nbins, with_sums=("trimmed_mean" in need_sketch),
                       device=device)
    for j in range(num_chunks):
        hist = hist_update(hist, chunk_fn(j), lo, width)
    counts, sums = hist

    if "median" in need_sketch:
        out["median"] = H.median_from_hist(counts, lo, width, m)
    if "trimmed_mean" in need_sketch:
        out["trimmed_mean"] = H.trimmed_mean_from_hist(
            counts, sums, lo, width, m, beta)
    return out


def aggregate_array_chunked(
    x: torch.Tensor,
    method: str = "median",
    beta: float = 0.1,
    chunk_rows: int = 256,
    cfg: SketchConfig = SketchConfig(),
) -> torch.Tensor:
    """The streaming aggregator over an in-memory (m, d) tensor in
    ``chunk_rows`` slices, on ``x``'s device (chunk-invariance checks)."""
    m, d = x.shape
    bounds = [(s, min(s + chunk_rows, m)) for s in range(0, m, chunk_rows)]
    return streaming_aggregate(
        lambda j: x[bounds[j][0]:bounds[j][1]], len(bounds), d, method, beta, cfg)
