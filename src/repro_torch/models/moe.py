"""Mixture-of-Experts FFN: a top-k router with capacity-based dispatch and
the Switch auxiliary loss (the reference's ``repro.models.moe``).

Each expert processes at most ``cap = min(S, max(4, round_up(int(cf·k·S/E),
4)))`` tokens of a sequence.  Slots are filled in top-k order: a token's
position in its k-th expert is the number of earlier tokens of the
sequence routed there in the same top-k slot, plus what the earlier slots
kept; a token past ``cap`` is dropped from the FFN (identity residual).

The reference builds dense one-hot dispatch / combine tensors (B, S, E, C)
and contracts them with einsums.  Here :func:`route` gives the same
assignment in index form, the kept tokens are gathered into one
(E, B·C, D) buffer, and the experts run as one batched product over E;
the combine (:func:`repro_torch.kernels.moe_combine.moe_combine`, a
hand-written kernel on the card) sums each token's kept outputs,
weighted, in float32, and its backward writes each kept row's gradient
once.  Nothing reads the card's values on the host.

Under a model axis (``ctx``, ``split``) the router is whole on every rank
(its caller gathers it), so routing is the global top-k.  ``experts``:
each rank runs the tokens routed to its E/M experts and combines them,
the others' slots weighing 0; ``hidden``: each rank runs every expert on
its F/M columns.  Either way the ranks' partial outputs are psummed (the
combine is linear), and the combine weights enter the ranks through
Megatron's f, so that their gradient is the ranks' sum.  Under the
context's ``seq_parallel`` the input is a rank's rows of S: they are
gathered whole (routing and capacity read the whole sequence) and the
output is reduce-scattered back to the rank's rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels.moe_combine import moe_combine
from repro_torch.models.sharding import NULL_CTX, ShardCtx


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def capacity(s: int, num_experts: int, top_k: int, capacity_factor: float = 1.25) -> int:
    """Tokens an expert takes per sequence of length ``s``."""
    return min(s, max(4, _round_up(int(capacity_factor * top_k * s / num_experts), 4)))


class Routing(NamedTuple):
    """Per (batch row, token, top-k slot): the expert, its capacity slot,
    whether the token was kept there, and its combine weight (the
    renormalized router probability; 0 where dropped)."""

    expert: torch.Tensor  # (B, S, K) int64
    slot: torch.Tensor  # (B, S, K) int64, in [0, cap) where kept
    keep: torch.Tensor  # (B, S, K) bool
    weight: torch.Tensor  # (B, S, K) float32


def route(probs: torch.Tensor, top_k: int, cap: int) -> Routing:
    """Top-k routing of router probabilities ``probs`` (B, S, E) with
    ``cap`` slots per expert and sequence, as the reference's dispatch and
    combine: ``dispatch[b, s, e, c] = 1`` iff some k has ``expert == e``,
    ``slot == c`` and ``keep``; ``combine`` the same with ``weight``.

    The reference fills the top-k slots one after the other, each adding
    what it kept to the expert's count; since a slot keeps tokens until the
    count reaches ``cap``, the count before slot k is ``min(cap, tokens
    routed to the expert in slots < k)``, so all slots are placed at once."""
    e = probs.shape[-1]
    top_p, top_idx = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    oh = F.one_hot(top_idx, e)  # (B, S, K, E)
    per_slot = torch.sum(oh, dim=1, keepdim=True)  # (B, 1, K, E)
    before = torch.clamp(torch.cumsum(per_slot, dim=2) - per_slot, max=cap)
    pos = torch.cumsum(oh, dim=1) - oh + before  # the reference's position, per expert
    slot = torch.gather(pos, -1, top_idx[..., None])[..., 0]  # (B, S, K)
    keep = slot < cap
    return Routing(expert=top_idx, slot=slot, keep=keep,
                   weight=torch.where(keep, top_p.float(), torch.zeros_like(top_p.float())))


@trace.spanned("moe.experts")
def _experts(x: torch.Tensor, r: Routing, weight: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor, w_down: torch.Tensor, cap: int, e0: int = 0,
             mine: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The float32 combine (B, S, D) of the experts ``e0 ..`` whose weights
    are given (``mine``: which (token, slot) pairs they hold; None = all)."""
    b, s, d = x.shape
    top_k = r.expert.shape[-1]
    el = w_gate.shape[0]
    keep = r.keep if mine is None else r.keep & mine
    # every (token, top-k slot) pair's row of the (E, B, C) buffer; a dropped
    # pair writes to one extra row that no expert reads (no host sync)
    rows = ((r.expert - e0) * b + torch.arange(b, device=x.device)[:, None, None]) * cap + r.slot
    trash = el * b * cap
    dest = torch.where(keep, rows, torch.full_like(rows, trash)).reshape(-1)
    src = x[:, :, None, :].expand(b, s, top_k, d).reshape(-1, d)
    xe = x.new_zeros((trash + 1, d)).index_copy(0, dest, src)[:trash].view(el, b * cap, d)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down).reshape(trash, d)
    return moe_combine(ye, rows, keep, weight)


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25, ctx: ShardCtx = NULL_CTX,
            split: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D); w_router (D, E), whole; w_gate / w_up (E, D, F); w_down
    (E, F, D) (a rank's shards under ``split``).  Returns (y (B, S, D) in
    x's dtype, the float32 Switch auxiliary loss ``E · Σ_e frac_e ·
    mean_p_e / k``); x and y a rank's rows of S under ``ctx.seq_parallel``."""
    x = ctx.sp_enter(NULL_CTX, x)  # a rank's rows under seq_parallel: routing reads all of S
    b, s, d = x.shape
    e = w_router.shape[1]
    cap = capacity(s, e, top_k, capacity_factor)
    with trace.span("moe.route"):
        probs = torch.softmax(x.float() @ w_router.float(), dim=-1)  # (B, S, E)
        r = route(probs, top_k, cap)
    c = ctx if split is not None else NULL_CTX
    xe, weight = c.enter(x), c.enter(r.weight)
    parts = []
    for k in c.ranks():
        xk, wk = c.local(xe, k), c.local(weight, k)
        if split == "experts":
            el = e // c.model
            e0 = k * el
            parts.append(_experts(xk, r, wk, c.shard(w_gate, 0, k), c.shard(w_up, 0, k),
                                  c.shard(w_down, 0, k), cap, e0,
                                  (r.expert >= e0) & (r.expert < e0 + el)))
        else:
            parts.append(_experts(xk, r, wk, c.shard(w_gate, 2, k), c.shard(w_up, 2, k),
                                  c.shard(w_down, 1, k), cap))
    y = ctx.sp_reduce(c, parts)

    kept = F.one_hot(r.expert, e) * r.keep[..., None]  # (B, S, K, E)
    per_expert = torch.sum(kept, dim=(0, 1, 2))
    trace.count("moe.pairs", b * s * top_k)
    trace.count("moe.kept", per_expert)
    frac = per_expert.float() / (b * s)
    mean_p = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac * mean_p) / top_k
    return y.to(x.dtype), aux
