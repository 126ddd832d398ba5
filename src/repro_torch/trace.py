"""Spans and counters inside the port, on ``torch.profiler``'s clock.

Tracing is off unless a caller turns it on with :func:`enabled`; there is
no environment variable and no flag.  Off, :func:`span` returns one shared
null context and :func:`count` records nothing, so an instrumented call
costs one flag test.  On, a span is a ``torch.profiler.record_function``
named ``"repro/" + name``: a host event of the profiler's trace, on the
same clock as the device's activities, so a trace lines the program's
layers up with its kernels with no conversion.  The flag is global, not a
thread's: spans also open on autograd's device thread, where
``torch.utils.checkpoint`` re-runs each super-block's forward, so every
operation of the recompute runs inside a ``block`` span.

Spans (the names are the API)::

    step              the step body (args: the global step index)
      worker.grads    every worker's gradients and their stacked rows
        worker.fwd_bwd  one worker's forward, backward and recompute
          block         a super-block's forward, and remat's recompute of it
            attention   scores, softmax, PV (models/attention.attention)
            moe.route   the router product, softmax and routing
            moe.experts dispatch, the expert products, the combine
        worker.stack  the copy of a worker's result into the (m, ...) rows
      aggregate       the robust strategy, its attack included
        attack        the attack on the stacked rows
        aggregate.select  the B1/B2 launch and its packing
      update          the optimizer's update

Counters (summed over the calls made while tracing is on):

- ``attn.scores``: score elements each KV block computes, B·KV·G·Sq·block
  (a padded last block counted whole); ``attn.kept``: those the mask keeps,
  worked out in closed form from the block's key range
  (:func:`kept_pairs`), never read from the card.
- ``moe.pairs``: (token, top-k slot) pairs, B·S·K; ``moe.kept``: the pairs
  an expert kept, the per-expert counts ``moe_ffn`` computes for its
  auxiliary loss, held by reference (no kernel of its own).

Under remat both the forward and the recompute of a super-block count, so
the kept shares are those of one forward.  A counter never launches a
kernel or synchronises; :func:`take_counts` resolves them (one transfer
per device) after the traced steps, and resets them.

Take a trace of some training steps with the spans::

    with repro_torch.trace.enabled(), torch.profiler.profile(...) as prof:
        for batch in batches:
            state = window(state, batch)
    prof.export_chrome_trace("train.json")
"""
from __future__ import annotations

import contextlib
import functools
from collections import defaultdict
from typing import Callable, Dict, List

import torch

PREFIX = "repro/"

#: what :func:`span` returns while tracing is off
NULL_SPAN = contextlib.nullcontext()

_on = False
_host: Dict[str, float] = defaultdict(float)
_device: Dict[str, List[torch.Tensor]] = defaultdict(list)


def on() -> bool:
    """Whether tracing is on."""
    return _on


@contextlib.contextmanager
def enabled():
    """Tracing on inside the block (and as it was after)."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def span(name: str, args=None):
    """A profiler range ``repro/<name>`` while tracing is on, else
    :data:`NULL_SPAN`; ``args`` (as a string) is shown beside it in the
    trace."""
    if not _on:
        return NULL_SPAN
    return torch.profiler.record_function(PREFIX + name, None if args is None else str(args))


def spanned(name: str) -> Callable[[Callable], Callable]:
    """A decorator: each call of the function inside :func:`span` ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return run
    return deco


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while tracing is on: a host
    number, or a tensor the program has already computed (its elements'
    sum counts; only the reference is kept)."""
    if not _on:
        return
    if isinstance(value, torch.Tensor):
        _device[name].append(value)
    else:
        _host[name] += value


def take_counts() -> Dict[str, float]:
    """Every counter's total since the last call, then reset: the device
    tensors summed where they live, read back once per device."""
    out = dict(_host)
    by_device: Dict[torch.device, List] = defaultdict(list)
    for name, ts in _device.items():
        for t in ts:
            by_device[t.device].append((name, t))
    for items in by_device.values():
        sums = torch.stack([t.detach().sum(dtype=torch.float64) for _, t in items]).tolist()
        for (name, _), s in zip(items, sums):
            out[name] = out.get(name, 0.0) + s
    _host.clear()
    _device.clear()
    return out


def _below(x: int, n: int) -> int:
    """Σ_{u <= x} clamp(u, 0, n)."""
    if x < 0:
        return 0
    if x <= n:
        return x * (x + 1) // 2
    return n * (n + 1) // 2 + (x - n) * n


def _at_most(sq: int, q0: int, k0: int, n: int, t: int) -> int:
    """Pairs (q, k), q in [q0, q0 + sq), k in [k0, k0 + n), with k - q <= t."""
    u0 = q0 + t - k0 + 1
    return _below(u0 + sq - 1, n) - _below(u0 - 1, n)


def kept_pairs(sq: int, q_offset: int, k_lo: int, k_hi: int, causal: bool,
               window: int) -> int:
    """How many (query, key) pairs of queries ``q_offset .. q_offset + sq``
    and keys ``k_lo .. k_hi`` the attention mask keeps (``causal``: key <=
    query; ``window`` > 0: key > query - window), in O(1)."""
    n = k_hi - k_lo
    if sq <= 0 or n <= 0:
        return 0
    upper = _at_most(sq, q_offset, k_lo, n, 0) if causal else sq * n
    lower = _at_most(sq, q_offset, k_lo, n, -window) if window and window > 0 else 0
    return max(0, upper - lower)
