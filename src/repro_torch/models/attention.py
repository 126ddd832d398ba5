"""GQA attention: plain, chunked (online softmax) and decode-with-cache
(the reference's ``repro.models.attention``).

Shapes use the grouped layout throughout: q (B, S, KV, G, hd) where
H = KV·G query heads share KV heads; k/v (B, S, KV, hd), so KV is never
repeated to H heads.  Scores, softmax and the weighted sum run in float32
and the output is cast back to q's dtype, as in the reference.  None of
these is a kernel of the reference (they are jnp there), so they are plain
torch here.
"""
from __future__ import annotations

import torch

from repro_torch import trace

NEG_INF = -1e30


def softmax_scale(hd: int) -> float:
    """1/sqrt(hd) rounded to float32, as the reference computes it."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Sk) boolean mask: True = attend."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window and window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def _count_block(q, block: int, k_lo: int, k_hi: int, causal: bool, window: int,
                 q_offset: int) -> None:
    """The trace's ``attn.scores`` / ``attn.kept`` of one block of ``block``
    keys, of which ``k_lo .. k_hi`` are real (the rest padding)."""
    b, sq, kv, g, _ = q.shape
    trace.count("attn.scores", b * kv * g * sq * block)
    kept = trace.kept_pairs(sq, q_offset, k_lo, k_hi, causal, window)
    trace.count("attn.kept", b * kv * g * kept)


def plain_attention(q, k, v, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Full-materialisation attention: q (B, Sq, KV, G, hd), k/v (B, Sk, KV, hd)."""
    if trace.on():
        _count_block(q, k.shape[1], 0, k.shape[1], causal, window, q_offset)
    scale = softmax_scale(q.shape[-1])
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    m = _mask(qpos, kpos, causal, window)
    logits = torch.where(m[None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, causal: bool = True, window: int = 0, q_offset: int = 0,
                      kv_block: int = 1024):
    """Online-softmax attention over KV blocks; O(Sq·kv_block) live scores."""
    b, sq, kv, g, hd = q.shape
    sk = k.shape[1]
    scale = softmax_scale(hd)
    qf = q.float()
    qpos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros((b, kv, g, sq, hd), dtype=torch.float32, device=q.device)
    mx = torch.full((b, kv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    lse = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    for start in range(0, sk, kv_block):
        kc = k[:, start:start + kv_block].float()
        vc = v[:, start:start + kv_block].float()
        pad = kv_block - kc.shape[1]
        if pad:  # the reference pads the last block with zeros and masks it
            kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
        if trace.on():
            _count_block(q, kv_block, start, min(start + kv_block, sk), causal, window, q_offset)
        kpos = start + torch.arange(kv_block, device=q.device)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale
        msk = _mask(qpos, kpos, causal, window) & (kpos < sk)[None, :]
        logits = torch.where(msk[None, None, None], logits, NEG_INF)
        new_mx = torch.maximum(mx, torch.amax(logits, dim=-1))
        corr = torch.exp(mx - new_mx)
        p = torch.exp(logits - new_mx[..., None])
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
        lse = lse * corr + torch.sum(p, dim=-1)
        mx = new_mx
    out = acc / torch.clamp(lse[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B, Sq, KV, G, hd)


@trace.spanned("attention")
def attention(q, k, v, causal: bool = True, window: int = 0, q_offset: int = 0,
              kv_block: int = 1024):
    """Dispatch: plain for short sequences (or ``kv_block`` 0), chunked otherwise."""
    if kv_block == 0 or k.shape[1] <= kv_block:
        return plain_attention(q, k, v, causal, window, q_offset)
    return chunked_attention(q, k, v, causal, window, q_offset, kv_block)


def decode_attention(q, k_cache, v_cache, pos, window: int = 0, pos_offset: int = 0):
    """Single-token attention against a (possibly ring-buffer) cache.

    q (B, 1, KV, G, hd); k/v_cache (B, S_cache, KV, hd), including the new
    token; ``pos`` the new token's absolute position; cache slot s holds
    absolute position ``pos_offset + s``.
    """
    scale = softmax_scale(q.shape[-1])
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k_cache.float()) * scale
    kpos = pos_offset + torch.arange(k_cache.shape[1], device=q.device)
    ok = kpos <= pos
    if window and window > 0:
        ok &= kpos > pos - window
    logits = torch.where(ok[None, None, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return out.to(q.dtype)
