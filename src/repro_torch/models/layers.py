"""Shared neural-net building blocks on tensors (the reference's
``repro.models.layers``).

Every function computes in the precision the reference does: norms and
rotary embeddings in float32, cast back to the input's dtype; matrix
products in the operands' dtype (float32 accumulation on both devices).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def rms_normalize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x`` in float32 over its root mean square (each row of the last
    dim): :func:`rms_norm` before its scale."""
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return (rms_normalize(x, eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding.

    x: (..., S, H, hd) with hd even; positions: (..., S) absolute positions.
    """
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exps)
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def geglu(x, w_gate, w_up, w_down):
    # jax.nn.gelu's default is the tanh approximation
    return (F.gelu(x @ w_gate, approximate="tanh") * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


def sinusoidal_positions(n: int, d: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings (n, d)."""
    half = d // 2
    scale = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                      * (math.log(10000.0) / (half - 1)))
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None] * scale[None, :]
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level mean cross entropy. logits (..., V), labels (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
