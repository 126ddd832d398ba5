"""Selection-network order-statistic engine: the comparator-program
generator (a copy of the reference's pure-Python generator) and the
torch executors that are the plain versions of the CUDA kernels in
:mod:`repro_torch.kernels.robust_agg`.

Generator
---------
:func:`batcher_network` is Batcher's odd-even mergesort for the next
power of two, clipped to m wires (exact: the network is standard, so
virtual wires >= m behave as +inf sentinels).  :func:`prune_network`
drops every comparator whose outputs cannot reach a requested rank wire
(backward liveness), so a program computes only the median wires or the
trim band.  The programs are identical, comparator for comparator, to
the reference's (tests/test_torch_selection_network.py checks every
m in 2..64 and every legal trim).

Executors
---------
:func:`apply_network` runs a program on a list of row tensors with
:func:`ieee_minimum` / :func:`ieee_maximum`, which reproduce
``jnp.minimum`` / ``jnp.maximum``: NaN propagates and -0 < +0.  (The
torch primitives return their first argument on a ±0 tie, so they are
not used bare.)  ``band_mean_from_rows`` sums the band in rank order in
float32 and divides truly — bitwise the reference's eager executor.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Sequence, Tuple

import torch

Comparator = Tuple[int, int]

# Largest worker count the unrolled network pays for; above it the
# aggregators use torch.sort / torch.topk.  Single source of truth for
# kernels/ops.py, kernels/robust_agg.py and core/aggregators.py.
NETWORK_MAX_M = 64


# --------------------------------------------------------------------------
# base networks
# --------------------------------------------------------------------------


def _next_pow2(m: int) -> int:
    p = 1
    while p < m:
        p *= 2
    return p


def _oddeven_merge(lo: int, hi: int, r: int, out: List[Comparator]) -> None:
    step = r * 2
    if step < hi - lo:
        _oddeven_merge(lo, hi, step, out)
        _oddeven_merge(lo + r, hi, step, out)
        out.extend((i, i + r) for i in range(lo + r, hi - r, step))
    else:
        out.append((lo, lo + r))


def _oddeven_sort(lo: int, hi: int, out: List[Comparator]) -> None:
    if hi - lo >= 1:
        mid = lo + (hi - lo) // 2
        _oddeven_sort(lo, mid, out)
        _oddeven_sort(mid + 1, hi, out)
        _oddeven_merge(lo, hi, 1, out)


@functools.lru_cache(maxsize=None)
def batcher_network(m: int) -> Tuple[Comparator, ...]:
    """Batcher odd-even mergesort network for any m >= 1 (standard form:
    min always to the lower wire), clipped from the next power of two."""
    if m <= 1:
        return ()
    p = _next_pow2(m)
    full: List[Comparator] = []
    _oddeven_sort(0, p - 1, full)
    return tuple((i, j) for i, j in full if j < m)


@functools.lru_cache(maxsize=None)
def transposition_network(m: int) -> Tuple[Comparator, ...]:
    """Odd-even transposition sort: m passes of neighbour compare-exchanges
    (the O(m^2) full network the pruned programs are measured against)."""
    out: List[Comparator] = []
    for p in range(m):
        out.extend((i, i + 1) for i in range(p % 2, m - 1, 2))
    return tuple(out)


# --------------------------------------------------------------------------
# dead-wire elimination
# --------------------------------------------------------------------------


def prune_network(
    comparators: Sequence[Comparator], m: int, ranks: Sequence[int]
) -> Tuple[Comparator, ...]:
    """Keep only comparators whose outputs (transitively) reach a requested
    rank wire (backward liveness pass)."""
    live = bytearray(m)
    for r in ranks:
        if not 0 <= r < m:
            raise ValueError(f"rank {r} out of range for m={m}")
        live[r] = 1
    kept: List[Comparator] = []
    for i, j in reversed(comparators):
        if live[i] or live[j]:
            kept.append((i, j))
            live[i] = live[j] = 1
    kept.reverse()
    return tuple(kept)


# --------------------------------------------------------------------------
# programs
# --------------------------------------------------------------------------


def median_ranks(m: int) -> Tuple[int, ...]:
    """Rank set of Definition 1: the middle wire (odd m) or the two middle
    wires whose f32 midpoint is the median (even m)."""
    if m % 2 == 1:
        return (m // 2,)
    return (m // 2 - 1, m // 2)


def band_ranks(m: int, trim: int) -> Tuple[int, ...]:
    """Rank set of Definition 2's kept band [trim, m - trim)."""
    if not (0 <= trim and 2 * trim < m):
        raise ValueError(f"invalid trim {trim} for m={m}")
    return tuple(range(trim, m - trim))


@dataclasses.dataclass(frozen=True)
class SelectionProgram:
    """A pruned static min/max program computing ``ranks`` of m rows."""

    m: int
    ranks: Tuple[int, ...]
    comparators: Tuple[Comparator, ...]
    full_size: int  # comparator count of the unpruned base network

    @property
    def size(self) -> int:
        return len(self.comparators)


@functools.lru_cache(maxsize=None)
def selection_program(
    m: int, ranks: Tuple[int, ...], base: str = "batcher"
) -> SelectionProgram:
    """Build (and cache) the pruned program for a rank set.

    ``base``: ``batcher`` (default, fewest comparators) or
    ``transposition`` (the full network, for comparison).
    """
    if base == "batcher":
        net = batcher_network(m)
    elif base == "transposition":
        net = transposition_network(m)
    else:
        raise ValueError(f"unknown base network {base!r}")
    ranks = tuple(sorted(set(ranks)))
    return SelectionProgram(m, ranks, prune_network(net, m, ranks), len(net))


def median_program(m: int, base: str = "batcher") -> SelectionProgram:
    return selection_program(m, median_ranks(m), base)


def trimmed_program(m: int, trim: int, base: str = "batcher") -> SelectionProgram:
    return selection_program(m, band_ranks(m, trim), base)


def fused_program(m: int, trim: int, base: str = "batcher") -> SelectionProgram:
    """One program whose live wires cover the trim band AND the median
    ranks: median and trimmed mean from a single pass over the rows."""
    return selection_program(
        m, tuple(sorted(set(band_ranks(m, trim)) | set(median_ranks(m)))), base)


# --------------------------------------------------------------------------
# executors (the plain versions of the CUDA kernels)
# --------------------------------------------------------------------------


def ieee_minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``: NaN propagates and -0 < +0."""
    tie = torch.where(torch.signbit(a), a, b)
    return torch.where(a == b, tie, torch.minimum(a, b))


def ieee_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: NaN propagates and -0 < +0."""
    tie = torch.where(torch.signbit(a), b, a)
    return torch.where(a == b, tie, torch.maximum(a, b))


def apply_network(
    rows: Sequence,
    comparators: Sequence[Comparator],
    minimum: Callable = ieee_minimum,
    maximum: Callable = ieee_maximum,
) -> list:
    """Run a compare-exchange program on a list of row values."""
    rows = list(rows)
    for i, j in comparators:
        a, b = rows[i], rows[j]
        rows[i], rows[j] = minimum(a, b), maximum(a, b)
    return rows


def median_from_rows(rows: list, m: int, dtype) -> torch.Tensor:
    if m % 2 == 1:
        return rows[m // 2]
    lo = rows[m // 2 - 1].float()
    hi = rows[m // 2].float()
    # f32 midpoint, cast back — matches ref.median_ref / coordinate_median
    return ((lo + hi) * 0.5).to(dtype)


def band_mean_from_rows(rows: list, m: int, trim: int, dtype) -> torch.Tensor:
    acc = rows[trim].float()
    for i in range(trim + 1, m - trim):
        acc = acc + rows[i].float()
    # A full-size divisor keeps this a true IEEE division on every device
    # (CUDA's div by a host scalar multiplies by the reciprocal instead).
    return (acc / torch.full_like(acc, m - 2 * trim)).to(dtype)


def median_select(x: torch.Tensor, base: str = "batcher") -> torch.Tensor:
    """Coordinate-wise median of ``x`` (m, ...) via the pruned network."""
    m = x.shape[0]
    if m == 1:
        return x[0]
    prog = median_program(m, base)
    rows = apply_network(x.unbind(0), prog.comparators)
    return median_from_rows(rows, m, x.dtype)


def trimmed_mean_select(x: torch.Tensor, trim: int, base: str = "batcher") -> torch.Tensor:
    """Coordinate-wise trimmed mean of ``x`` (m, ...) via the pruned
    band-selection network (trim = floor(beta*m) rows off each end)."""
    m = x.shape[0]
    if trim == 0 and m == 1:
        return x[0]
    prog = trimmed_program(m, trim, base)
    rows = apply_network(x.unbind(0), prog.comparators)
    return band_mean_from_rows(rows, m, trim, x.dtype)


def median_and_trimmed_select(
    x: torch.Tensor, trim: int, base: str = "batcher"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Median AND trimmed mean from one pass over the rows (fused rank set)."""
    m = x.shape[0]
    prog = fused_program(m, trim, base)
    rows = apply_network(x.unbind(0), prog.comparators)
    return (median_from_rows(rows, m, x.dtype),
            band_mean_from_rows(rows, m, trim, x.dtype))


def rank_select(x: torch.Tensor, rank: int, base: str = "batcher") -> torch.Tensor:
    """Single order statistic (0-indexed) — nearest-rank quantiles."""
    m = x.shape[0]
    prog = selection_program(m, (rank,), base)
    rows = apply_network(x.unbind(0), prog.comparators)
    return rows[rank]
