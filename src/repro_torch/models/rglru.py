"""RG-LRU recurrent block (RecurrentGemma / Griffin; the reference's
``repro.models.rglru``; arXiv:2402.19427).

Recurrence, per channel:
  r_t = σ(W_a x_t + b_a)            recurrence gate
  i_t = σ(W_x x_t + b_x)            input gate
  a_t = exp(-c · softplus(Λ) · r_t) with c = 8
  h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

A full sequence runs a log-depth scan over time: the pairs (a, u) compose
associatively, and :func:`associative_scan` is the odd/even recursion that
``jax.lax.associative_scan`` runs, on strided slices of the time axis (S
eager launches a layer would be a loop over time).  Decode is the O(1)
state update.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

RG_LRU_C = 8.0


def _gates(x, w_a, b_a, w_x, b_x, lam, own=None):
    """(a, gated input) in float32.  ``own``: the channels the gates apply
    to where ``w_a`` / ``w_x`` (and ``b_a``, ``b_x``, ``lam``) are a model
    rank's columns of them (the gates read every channel of ``x``);
    default ``x``."""
    xf = x.float()
    r = torch.sigmoid(xf @ w_a.float() + b_a)
    i = torch.sigmoid(xf @ w_x.float() + b_x)
    log_a = -RG_LRU_C * F.softplus(lam.float()) * r  # (B, S, C) <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * i * (
        xf if own is None else own.float())
    return a, gated


def _combine(c1, c2):
    a1, u1 = c1
    a2, u2 = c2
    return a1 * a2, a2 * u1 + u2


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a0 b0 a1 b1 ... along ``dim``; ``a`` may be one longer than ``b``."""
    n = b.shape[dim]
    head = torch.stack([a.narrow(dim, 0, n), b], dim=dim + 1).flatten(dim, dim + 1)
    if a.shape[dim] == n:
        return head
    return torch.cat([head, a.narrow(dim, n, 1)], dim=dim)


def associative_scan(fn, elems: Tuple[torch.Tensor, ...], dim: int):
    """Inclusive scan of ``fn`` over ``dim``, in the order of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan them
    recursively (the odd results), then combine each odd result with the
    next even input."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems), tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd), tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def rglru_scan(x: torch.Tensor, w_a, b_a, w_x, b_x, lam,
               h0: Optional[torch.Tensor] = None, own: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, C) -> (y (B, S, C) in x's dtype, h_final (B, C) f32).  With
    ``own`` (B, S, c), a model rank's channels of ``x`` whose gate columns
    ``w_a`` / ``w_x`` (C, c) and ``b_a``, ``b_x``, ``lam`` (c,) are: y (B, S,
    c) and h_final (B, c) of those channels."""
    a, u = _gates(x, w_a, b_a, w_x, b_x, lam, own)
    if h0 is not None:
        # fold the initial state into the first input: h_0' = a_0 h0 + u_0
        u = torch.cat([u[:, :1] + a[:, :1] * h0.float()[:, None], u[:, 1:]], dim=1)
    _, hs = associative_scan(_combine, (a, u), dim=1)
    return hs.to(x.dtype), hs[:, -1]


def rglru_decode_step(state: torch.Tensor, x: torch.Tensor, w_a, b_a, w_x, b_x, lam,
                      own: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """state (B, C), x (B, 1, C) -> (y (B, 1, C) in x's dtype, new f32 state);
    ``own`` as :func:`rglru_scan`'s (the state then the rank's (B, c))."""
    a, u = _gates(x, w_a, b_a, w_x, b_x, lam, own)
    h = a[:, 0] * state.float() + u[:, 0]
    return h[:, None].to(x.dtype), h
