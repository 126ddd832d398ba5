"""Dispatch wrappers around the robust-aggregation kernels.

``robust_aggregate(x, method, beta)`` accepts any (m, ...) tensor,
flattens the coordinate space, dispatches, and restores the shape.
Backends:

- ``cuda``     the hand-written kernels (:mod:`robust_agg`); a CPU
  tensor given to them takes their plain version;
- ``network``  the same pruned selection program run as torch min/max
  (:mod:`selection_network`) — the CPU path;
- ``sort``     the ``torch.sort`` oracle (:mod:`ref`), and the path for
  m above the network limit.

``auto`` decides by shape, dtype and device alone, before any kernel runs
(:func:`route`): ``empty`` (no coordinates: an empty result, no
launch), ``sort`` above NETWORK_MAX_M rows, ``cuda`` for CUDA tensors of the
kernels' dtypes (f32, bf16, f16), ``network`` for every other tensor with
m >= 2 (the CPU, and float64 on the card: the reference, too, aggregates
float64 only through its jnp selection network, never a kernel), else
``sort``.  A kernel that fails to build or launch raises; nothing falls
back.
``fused_median_trimmed`` returns median AND trimmed mean from one pass.
``median`` and ``trimmed_mean`` are the reference's partials of
``robust_aggregate``: ``trimmed_mean`` is ``robust_aggregate`` itself, so
it takes the median unless ``method="trimmed_mean"`` is passed.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref, robust_agg, selection_network as SN
from repro_torch.kernels.selection_network import NETWORK_MAX_M

BACKENDS = ("auto", "cuda", "network", "sort")


def _check_network_m(m: int) -> None:
    """Explicit backend='network' / 'cuda' must respect the same limit as
    auto dispatch: above NETWORK_MAX_M the comparator program is
    O(m log^2 m) ops per coordinate."""
    if m > NETWORK_MAX_M:
        raise ValueError(
            f"the selection network supports m <= {NETWORK_MAX_M}, got m={m}; "
            "use backend='sort' (or 'auto') for larger worker counts")


def route(m: int, n: int, dtype: torch.dtype, device_type: str) -> str:
    """The route ``backend="auto"`` takes for m rows of n coordinates of
    ``dtype`` on a ``device_type`` ("cpu" or "cuda"; "meta", a dry-run's
    stand-in, routes as "cuda") tensor."""
    if n == 0:
        return "empty"
    if m > NETWORK_MAX_M:
        return "sort"
    if device_type in ("cuda", "meta") and dtype in robust_agg.DTYPES:
        return "cuda"
    return "network" if m >= 2 else "sort"


def auto_backend(x: torch.Tensor) -> str:
    """The route ``backend="auto"`` takes for the (m, ...) tensor ``x``."""
    return route(x.shape[0], x[0].numel(), x.dtype, x.device.type)


def _backend(backend: str, x: torch.Tensor) -> str:
    m = x.shape[0]
    if backend == "auto":
        return auto_backend(x)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend in ("cuda", "network"):
        _check_network_m(m)
    return backend


def _mean(flat: torch.Tensor) -> torch.Tensor:
    return flat.float().mean(dim=0).to(flat.dtype)


def robust_aggregate(
    x: torch.Tensor,
    method: str = "median",
    beta: float = 0.1,
    backend: str = "auto",
) -> torch.Tensor:
    """Aggregate (m, ...) -> (...) coordinate-wise with the given method."""
    m = x.shape[0]
    backend = _backend(backend, x)
    if backend == "empty" and method in ("median", "trimmed_mean", "mean"):
        return torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    flat = x.reshape(m, -1).contiguous()
    if method == "median":
        if backend == "cuda":
            out = robust_agg.median(flat)
        elif backend == "network":
            out = SN.median_select(flat)
        else:
            out = ref.median_ref(flat)
    elif method == "trimmed_mean":
        trim = int(beta * m)
        if backend == "cuda":
            out = robust_agg.trimmed_mean(flat, trim)
        elif backend == "network":
            out = SN.trimmed_mean_select(flat, trim) if trim else _mean(flat)
        else:
            out = ref.trimmed_mean_ref(flat, beta)
    elif method == "mean":
        out = _mean(flat)
    else:
        raise ValueError(f"unknown method {method!r}")
    return out.reshape(x.shape[1:])


def fused_median_trimmed(
    x: torch.Tensor,
    beta: float = 0.1,
    backend: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(median, trimmed_mean) of (m, ...) from ONE pass over the rows.

    The fused selection program computes the union rank set, so the two
    estimators share every compare-exchange and the (m, d) matrix is read
    once.
    """
    m = x.shape[0]
    trim = int(beta * m)
    backend = _backend(backend, x)
    if backend == "empty":
        return (torch.empty(x.shape[1:], dtype=x.dtype, device=x.device),
                torch.empty(x.shape[1:], dtype=x.dtype, device=x.device))
    flat = x.reshape(m, -1).contiguous()
    if backend == "cuda":
        med, tm = robust_agg.fused_median_trimmed(flat, trim)
    elif backend == "network":
        med, tm = SN.median_and_trimmed_select(flat, trim)
    else:
        med, tm = ref.median_ref(flat), ref.trimmed_mean_ref(flat, beta)
    return med.reshape(x.shape[1:]), tm.reshape(x.shape[1:])


median = functools.partial(robust_aggregate, method="median")
trimmed_mean = robust_aggregate  # explicit method kwarg recommended
