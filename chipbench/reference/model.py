"""A decoder of attention layers in plain float32 torch: the model of the
dense and MoE configurations, frozen from the port's plain model code
(``repro_torch.models.transformer`` / ``attention`` / ``moe`` /
``layers`` at the commit that added this benchmark) and written out
without its sharding, caches, chunking or checkpointing.

Per layer: ``x += wo·attn(rope(norm(x)·wq), rope(norm(x)·wk), norm(x)·wv)``
with grouped kv heads (query head h reads kv head h // G) and a causal
mask within ``sliding_window``; then ``x += ffn(norm(x))``, SwiGLU or the
top-k MoE with per-sequence expert capacity (tokens past an expert's
capacity skip it) and the Switch auxiliary loss.  RMS norms scale by
``1 + w``.  The loss is the mean cross entropy plus 0.01 times the sum
of the layers' auxiliary losses.

Every matrix product the port runs in the model's dtype goes through
``mm(a, b)`` (:func:`matmul`: float32 here; the control passes a lower
precision); the attention scores, softmax, norms, router and loss are
float32 as in the port.  The module has the interface that
:mod:`chipbench.reference` documents; :func:`model_flops_per_step` is
the work a step has to do, counted from the shapes alone.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Leaves = Dict[str, List[torch.Tensor]]  # path -> one tensor a layer (one for the rest)
NEG_INF = -1e30


def head_dim(model: Dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def _layer_leaves(model: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """One attention layer's leaves: shape and init kind."""
    d, h, kv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], head_dim(model)
    out = {"ln1": ((d,), "norm"), "ln2": ((d,), "norm"),
           "wq": ((d, h * hd), "w"), "wk": ((d, kv * hd), "w"),
           "wv": ((d, kv * hd), "w"), "wo": ((h * hd, d), "out")}
    if model.get("qk_norm"):
        out["q_norm"] = ((hd,), "norm")
        out["k_norm"] = ((hd,), "norm")
    moe = model.get("moe")
    if moe:
        e, fe = moe["num_experts"], moe["d_expert"]
        out.update(router=((d, e), "w"), we_g=((e, d, fe), "w"), we_u=((e, d, fe), "w"),
                   we_d=((e, fe, d), "out"))
    else:
        out.update(wg=((d, model["d_ff"]), "w"), wu=((d, model["d_ff"]), "w"),
                   wd=((model["d_ff"], d), "out"))
    return dict(sorted(out.items()))


def param_specs(model: Dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Every weight leaf by path, in the port's tree order (keys sorted;
    a layer's leaves stacked (n_layers, ...) under ``blocks/p0_attn``):
    (shape, std of its N(0, std²) draw).  Norm scales draw with std 0.02
    like the weights; output projections with 0.02 / sqrt(2·n_layers)."""
    if model.get("family") not in ("dense", "moe"):
        raise ValueError(f"the reference runs dense and moe decoders, not {model.get('family')!r}")
    n = model["n_layers"]
    std = {"w": 0.02, "norm": 0.02, "out": 0.02 / math.sqrt(2.0 * n)}
    specs = {f"blocks/p0_attn/{k}": ((n,) + shape, std[kind])
             for k, (shape, kind) in _layer_leaves(model).items()}
    specs["embed"] = ((model["vocab"], model["d_model"]), 0.02)
    specs["final_norm"] = ((model["d_model"],), 0.02)
    specs["lm_head"] = ((model["d_model"], model["vocab"]), 0.02)
    return dict(sorted(specs.items()))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


# ---------------------------------------------------------------------------
# the work of a step
# ---------------------------------------------------------------------------


def matmul_params_per_token(model: Dict) -> int:
    """Weights a token is multiplied by in the forward pass: the attention
    projections, the dense FFN or the router and the top-k experts' FFNs,
    and the lm head (the embedding is a lookup)."""
    d, h, kv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], head_dim(model)
    per_layer = d * h * hd * 2 + d * kv * hd * 2
    moe = model.get("moe")
    if moe:
        per_layer += d * moe["num_experts"] + moe["top_k"] * 3 * d * moe["d_expert"]
    else:
        per_layer += 3 * d * model["d_ff"]
    return model["n_layers"] * per_layer + d * model["vocab"]


def attention_pairs(seq: int, window: int) -> int:
    """(query, key) pairs a causal sequence of ``seq`` tokens scores, a key
    at most ``window`` - 1 positions back (``window`` 0: all before)."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def model_flops_per_step(model: Dict, traffic: Dict) -> float:
    """A training step's model FLOPs: 6 per matmul weight a token meets,
    and 12 per causal (query, key) pair and head dimension (QKᵀ and PV,
    forward and backward), over every worker's tokens.  The recompute of
    checkpointed layers and the experts' capacity padding are not work
    the model needs, and are not counted."""
    seqs = traffic["workers"] * traffic["batch_per_worker"]
    s = traffic["seq_len"]
    attn = (12 * attention_pairs(s, model.get("sliding_window", 0))
            * model["n_heads"] * head_dim(model) * model["n_layers"])
    return seqs * (6.0 * matmul_params_per_token(model) * s + attn)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, hd) at positions 0..S-1, halves
    rotated (the port's ``layers.rope``)."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device),
                            torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> torch.Tensor:
    """q (B, S, KV, G, hd), k / v (B, S, KV, hd) -> (B, S, KV·G·hd): causal
    softmax attention, a key more than ``window`` - 1 positions back
    masked where ``window`` > 0."""
    b, s, kv, g, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k) * scale
    pos = torch.arange(s, device=q.device)
    ok = pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(torch.where(ok, logits, NEG_INF), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, s, kv * g * hd)


def capacity(s: int, num_experts: int, top_k: int, factor: float = 1.25) -> int:
    """Tokens an expert takes per sequence of length ``s``."""
    return min(s, max(4, -(-int(factor * top_k * s / num_experts) // 4) * 4))


def moe(y: torch.Tensor, p: Dict[str, torch.Tensor], top_k: int, mm: Callable):
    """The MoE FFN of y (B, S, D) -> (out, Switch aux loss).  Each token's
    top-k experts by router probability, weights renormalized over the k;
    an expert keeps the first ``capacity`` of a sequence's tokens routed to
    it, filling the top-1 choices first, then the top-2, ...; a token it
    does not keep skips it.  The experts run as batched products over an
    (E, B·cap, D) buffer of the kept tokens (the port's index form)."""
    b, s, d = y.shape
    e = p["router"].shape[1]
    cap = capacity(s, e, top_k)
    probs = torch.softmax(y @ p["router"], dim=-1)  # (B, S, E), float32 as in the port
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    oh = F.one_hot(top_i, e)  # (B, S, K, E)
    per_choice = oh.sum(1, keepdim=True)  # (B, 1, K, E) tokens of each choice rank
    before = torch.clamp(torch.cumsum(per_choice, 2) - per_choice, max=cap)
    slot = torch.gather(torch.cumsum(oh, 1) - oh + before, -1, top_i[..., None])[..., 0]
    keep = slot < cap
    weight = torch.where(keep, top_p, torch.zeros_like(top_p))
    # each kept (token, choice) pair's row of an (E, B, cap) buffer; the
    # pairs not kept write one spare row that no expert reads
    rows = (top_i * b + torch.arange(b, device=y.device)[:, None, None]) * cap + slot
    spare = e * b * cap
    dest = torch.where(keep, rows, torch.full_like(rows, spare)).reshape(-1)
    src = y[:, :, None, :].expand(b, s, top_k, d).reshape(-1, d)
    xe = y.new_zeros((spare + 1, d)).index_copy(0, dest, src)[:spare].view(e, b * cap, d)
    h = F.silu(mm(xe, p["we_g"])) * mm(xe, p["we_u"])
    ye = mm(h, p["we_d"]).reshape(spare, d)
    picked = ye[torch.where(keep, rows, torch.zeros_like(rows))]  # (B, S, K, D)
    out = torch.sum(picked * weight[..., None], dim=2)
    frac = (oh * keep[..., None]).sum((0, 1, 2)).float() / (b * s)
    aux = e * torch.sum(frac * probs.mean((0, 1))) / top_k
    return out, aux


def layer(x: torch.Tensor, p: Dict[str, torch.Tensor], model: Dict, mm: Callable):
    """One attention layer -> (x, aux)."""
    b, s, _ = x.shape
    kv, hd = model["n_kv_heads"], head_dim(model)
    g = model["n_heads"] // kv
    eps = model["norm_eps"]
    y = rms_norm(x, p["ln1"], eps)
    q = mm(y, p["wq"]).reshape(b, s, kv * g, hd)
    k = mm(y, p["wk"]).reshape(b, s, kv, hd)
    v = mm(y, p["wv"]).reshape(b, s, kv, hd)
    if model.get("qk_norm"):
        q, k = rms_norm(q, p["q_norm"], eps), rms_norm(k, p["k_norm"], eps)
    q = rope(q, model["rope_theta"]).reshape(b, s, kv, g, hd)
    k = rope(k, model["rope_theta"])
    x = x + mm(attention(q, k, v, model.get("sliding_window", 0)), p["wo"])
    y = rms_norm(x, p["ln2"], eps)
    if model.get("moe"):
        f, aux = moe(y, p, model["moe"]["top_k"], mm)
    else:
        f = mm(F.silu(mm(y, p["wg"])) * mm(y, p["wu"]), p["wd"])
        aux = torch.zeros((), device=x.device)
    return x + f, aux


def loss(leaves: Leaves, tokens: torch.Tensor, labels: torch.Tensor, model: Dict,
         mm: Callable = matmul) -> torch.Tensor:
    """Mean cross entropy of ``labels`` plus 0.01 times the summed aux
    losses; each layer checkpointed (recomputed in the backward)."""
    names = [p.split("/")[-1] for p in leaves if p.startswith("blocks/")]
    x = leaves["embed"][0][tokens.long()]
    aux = torch.zeros((), device=x.device)

    def one(x, *ws):
        return layer(x, dict(zip(names, ws)), model, mm)

    for i in range(model["n_layers"]):
        ws = [leaves[f"blocks/p0_attn/{n}"][i] for n in names]
        x, a = checkpoint(one, x, *ws, use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, leaves["final_norm"][0], model["norm_eps"])
    logits = mm(x, leaves["lm_head"][0])
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return nll.mean() + 0.01 * aux


# ---------------------------------------------------------------------------
# the control: the same products in float8
# ---------------------------------------------------------------------------


def _to_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8 type) under one scale for the
    whole tensor, its largest magnitude at the type's largest value, and
    returned in x's dtype."""
    scale = torch.finfo(dtype).max / x.detach().abs().amax().float().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` of operands rounded to e4m3, its backward's products of
    the incoming gradient rounded to e5m2, as float8 training runs them."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _to_fp8(a, torch.float8_e4m3fn), _to_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _to_fp8(g, torch.float8_e5m2)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).transpose(0, 1) @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)
