"""Mamba-2 SSD mixer, state-space duality (the reference's
``repro.models.ssm``; arXiv:2405.21060).

Full sequences run the chunked SSD algorithm: a quadratic, attention-like
term within each chunk and a linear state recurrence between chunks (the
reference's ``lax.scan`` is a loop over the chunks here; the port keeps
its activations, so there is no ``jax.checkpoint``).  Decode is the O(1)
recurrent update.

Shapes (ngroups = 1):
  x (B, S, H, P)   the SSM branch per head, already scaled by dt
  loga (B, S, H)   log decay per step (dt · -exp(A_log))
  B, C (B, S, N)   input / output projections of the state, N = d_state
State: (B, H, P, N), float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, W-1, conv_dim): the rolling conv input window
    ssd: torch.Tensor  # (B, H, P, N)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., L) -> (..., L, L) lower-triangular segment sums:
    out[i, j] = sum_{k=j+1..i} a[k] for j < i, 0 on the diagonal, -inf
    above it (``torch.where``, so the backward takes no NaN from there)."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def ssd_chunked(x: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int = 256, h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32).

    A sequence that is not a multiple of ``chunk`` is padded with steps of
    ``loga = 0`` and ``x = 0``, which leave the state as it is."""
    b, s, h, p = x.shape
    dtype = x.dtype
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        loga = F.pad(loga, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    state = (torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    ys = []
    for c0 in range(0, x.shape[1], chunk):
        xk = x[:, c0:c0 + chunk].float()  # (B, L, H, P)
        ak = loga[:, c0:c0 + chunk].float()  # (B, L, H)
        bk = Bm[:, c0:c0 + chunk].float()  # (B, L, N)
        ck = Cm[:, c0:c0 + chunk].float()
        # 1) within-chunk (quadratic) term
        decay = torch.exp(_segsum(ak.transpose(1, 2)))  # (B, H, L, L)
        scores = torch.einsum("bln,bsn->bls", ck, bk)
        y_diag = torch.einsum("bhls,bls,bshp->blhp", decay, scores, xk)
        # 2) the carried-in state's contribution
        cum = torch.cumsum(ak, dim=1)  # (B, L, H)
        y_state = torch.einsum("bln,bhpn,blh->blhp", ck, state, torch.exp(cum))
        # 3) the chunk's final state
        total = torch.sum(ak, dim=1)  # (B, H)
        decay_out = torch.exp(total[:, None, :] - cum)  # from l (exclusive) to the end
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bln,blhp,blh->bhpn", bk, xk, decay_out)
        ys.append(y_diag + y_state)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(dtype), state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, loga: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: state (B, H, P, N), x (B, H, P) dt-scaled, loga (B, H),
    Bm / Cm (B, N) -> (y (B, H, P) in x's dtype, the new f32 state)."""
    a = torch.exp(loga.float())[:, :, None, None]
    upd = torch.einsum("bhp,bn->bhpn", x.float(), Bm.float())
    new_state = a * state + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv: x (B, S, C), w (W, C); ``prev`` (B, W-1, C)
    (a decode step's or a chunk's continuation) prefixes x.  Returns
    (silu(y), new_prev), the taps summed in the reference's order in x's
    dtype."""
    width = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], width - 1, x.shape[-1]))
    xp = torch.cat([prev, x], dim=1)  # (B, S+W-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    return F.silu(y), xp[:, -(width - 1):]
