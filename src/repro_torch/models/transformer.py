"""The dense decoder of the reference's unified model stack
(``repro.models.transformer``), on tensors.

embed → attention layers (GQA + RoPE, optional qk-norm / sliding window,
SwiGLU FFN) → final norm → lm head.

Parameters are the reference's tree: ``{"blocks": {"p0_attn": {...}},
"embed", "final_norm", "lm_head"}`` with every block leaf stacked
``(n_layers, ...)``, the same shapes (``x @ w`` with ``w`` (in, out)) and
dtypes.  Every dict is built with its keys in sorted order, so
:func:`repro_torch.tree.ravel` (insertion order) lays the coordinates out
as ``jax.flatten_util.ravel_pytree`` does (sorted keys): the adapter's
(m, D) gradient rows, the codecs' coordinate maps and the served
iterate's sha256 depend on it.

The port covers the dense family only.  A configuration with MoE, SSM or
RG-LRU layers, a hybrid pattern, an audio/vision frontend or an encoder
raises ``NotImplementedError`` (ROADMAP queue A item 8).

Entry points:
  init_params(cfg, seed, device)             -> params tree
  forward(params, tokens, cfg)               -> (logits, aux)
  loss_fn(params, batch, cfg)                -> scalar loss
  prefill(params, tokens, cfg, cache_len=)   -> (last-token logits, cache)
  decode_step(params, token, cache, pos, cfg) -> (logits, cache), the cache
                                                updated in place
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L

Params = Dict[str, Any]

#: the one layer group of a dense stack (the reference's ``p{i}_{kind}``)
LAYER = "p0_attn"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port lacks."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    if cfg.moe is not None:
        missing.append("MoE layers (models/moe.py)")
    if cfg.ssm is not None:
        missing.append("SSM layers (models/ssm.py)")
    if cfg.hybrid_pattern:
        missing.append(f"hybrid pattern {cfg.hybrid_pattern} (models/rglru.py)")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.n_enc_layers or cfg.cross_attention:
        missing.append("the encoder / cross-attention")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port has the dense decoder only; not ported: "
            f"{', '.join(missing)} (ROADMAP queue A item 8)")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_specs(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """One attention layer's leaves: name -> (shape, init std; 0 = zeros)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    std = 0.02
    out_std = std / math.sqrt(2.0 * cfg.n_layers)
    specs = {"ln1": ((d,), 0.0), "ln2": ((d,), 0.0),
             "wq": ((d, h * hd), std), "wk": ((d, kv * hd), std), "wv": ((d, kv * hd), std),
             "wo": ((h * hd, d), out_std)}
    if cfg.qk_norm:
        specs["q_norm"] = ((hd,), 0.0)
        specs["k_norm"] = ((hd,), 0.0)
    if cfg.d_ff:
        specs["wg"] = ((d, cfg.d_ff), std)
        specs["wu"] = ((d, cfg.d_ff), std)
        specs["wd"] = ((cfg.d_ff, d), out_std)
    return dict(sorted(specs.items()))


def _param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree as (shape, std) leaves, keys sorted at every level."""
    check_supported(cfg)
    std = 0.02
    layer = {k: ((cfg.n_layers,) + shape, s) for k, (shape, s) in _layer_specs(cfg).items()}
    return {"blocks": {LAYER: layer},
            "embed": ((cfg.vocab, cfg.d_model), std),
            "final_norm": ((cfg.d_model,), 0.0),
            "lm_head": ((cfg.d_model, cfg.vocab), std)}


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def _map_specs(fn, tree, path=""):
    if _is_spec(tree):
        return fn(path, *tree)
    return {k: _map_specs(fn, v, f"{path}/{k}" if path else k) for k, v in tree.items()}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters: N(0, std^2) in float32, cast to ``cfg.dtype``
    (norm scales zero), each leaf drawn on ``device`` from a generator
    seeded with (seed, leaf path).  The draws differ from the reference's
    threefry and between devices; parity tests convert the reference's
    parameters instead (:mod:`repro_torch.models.convert`)."""
    dev = resolve(device)
    dtype = _dt(cfg)

    def leaf(path, shape, std):
        if std == 0.0:
            return torch.zeros(shape, dtype=dtype, device=dev)
        g = rng.generator(seed, zlib.crc32(path.encode()), device=dev)
        x = torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
        return x.mul_(std).to(dtype)

    return _map_specs(leaf, _param_specs(cfg))


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as ``(shape, dtype)`` leaves, nothing allocated."""
    dtype = _dt(cfg)
    return _map_specs(lambda path, shape, std: (shape, dtype), _param_specs(cfg))


def count_params(cfg: ModelConfig) -> int:
    total = 0

    def add(path, shape, std):
        nonlocal total
        total += math.prod(shape)

    _map_specs(add, _param_specs(cfg))
    return total


def num_layers(params: Params) -> int:
    return len(params["blocks"][LAYER]["ln1"])


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s leaves: views of the stacked blocks, or the i-th entry
    where a block leaf is given as a sequence of per-layer tensors (what
    the adapter differentiates, so that each layer's gradient comes out
    at its own size instead of as a stacked-size zero tensor per layer)."""
    return {k: v[i] for k, v in params["blocks"][LAYER].items()}


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), params["embed"]).to(_dt(cfg))


def _qkv(p: Params, y: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Projections, qk-norm and RoPE of one layer: q (B, S, KV, G, hd),
    k and v (B, S, KV, hd)."""
    b, s, _ = y.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kv
    q = (y @ p["wq"]).reshape(b, s, kv, g, hd)
    k = (y @ p["wk"]).reshape(b, s, kv, hd)
    v = (y @ p["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta).reshape(b, s, kv, g, hd)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.d_ff:
        x = x + (F.silu(y @ p["wg"]) * (y @ p["wu"])) @ p["wd"]
    return x


def _attn_layer_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
                    window: int = 0, positions: Optional[torch.Tensor] = None,
                    kv_block: int = 1024, return_kv: bool = False):
    """One attention layer over a full sequence x (B, S, D) -> (x, aux[, (k, v)])."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    y = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, y, cfg, positions)
    o = attn_lib.attention(q, k, v, causal=causal, window=window, kv_block=kv_block)
    x = x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
    x = _ffn(p, x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return x, aux, (k, v)
    return x, aux


def _attn_window(cfg: ModelConfig) -> int:
    """Training/prefill attention window: native SWA, else full (0)."""
    return cfg.sliding_window or 0


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            kv_block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V), aux loss)."""
    check_supported(cfg)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_layers(params)):
        x, a = _attn_layer_fwd(layer_params(params, i), x, cfg, window=_attn_window(cfg),
                               positions=positions, kv_block=kv_block)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            kv_block: int = 1024, aux_weight: float = 0.01) -> torch.Tensor:
    logits, aux = forward(params, batch["tokens"], cfg, kv_block=kv_block)
    return L.cross_entropy(logits, batch["labels"], batch.get("mask")) + aux_weight * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_window(cfg: ModelConfig, cache_len: int) -> int:
    """Slots of an attention layer's cache: ``cache_len``, capped by the
    sliding window (native or the long-context variant) — a ring buffer."""
    cap = cfg.sliding_window or cfg.long_context_window
    return min(cache_len, cap) if cap else cache_len


def init_cache(cfg: ModelConfig, b: int, cache_len: int, device="cuda") -> Params:
    """Empty cache: k/v (n_layers, b, eff, KV, hd) and kpos (n_layers, eff)
    = -1 (every slot masked), as the reference's."""
    check_supported(cfg)
    dev = resolve(device)
    eff = cache_window(cfg, cache_len)
    shape = (cfg.n_layers, b, eff, cfg.n_kv_heads, cfg.hd)
    return {"blocks": {LAYER: {
        "k": torch.zeros(shape, dtype=_dt(cfg), device=dev),
        "kpos": torch.full((cfg.n_layers, eff), -1, dtype=torch.int32, device=dev),
        "v": torch.zeros(shape, dtype=_dt(cfg), device=dev)}}}


def _fill_attn_cache(k: torch.Tensor, v: torch.Tensor, eff: int, s: int) -> Params:
    """Place the last ``eff`` keys/values in ring order (slot = pos % eff)."""
    if eff >= s:
        kpos = torch.arange(eff, dtype=torch.int32, device=k.device)
        kpos = torch.where(kpos < s, kpos, torch.full_like(kpos, -1))
        pad = eff - s
        return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)), "kpos": kpos,
                "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
    pos = torch.arange(s - eff, s, dtype=torch.int32, device=k.device)
    order = torch.argsort(pos % eff)
    return {"k": k[:, s - eff:][:, order], "kpos": pos[order], "v": v[:, s - eff:][:, order]}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, kv_block: int = 1024,
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Full forward that also builds the serving cache, sized ``cache_len``
    (prompt + generation budget; default the prompt): returns the last
    token's logits (B, 1, V) and the cache."""
    check_supported(cfg)
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    eff = cache_window(cfg, cache_len)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)[None, :]
    layers = []
    for i in range(num_layers(params)):
        x, _, (k, v) = _attn_layer_fwd(layer_params(params, i), x, cfg,
                                       window=_attn_window(cfg), positions=positions,
                                       kv_block=kv_block, return_kv=True)
        layers.append(_fill_attn_cache(k, v, eff, s))
    cache = {"blocks": {LAYER: {key: torch.stack([c[key] for c in layers])
                                for key in ("k", "kpos", "v")}}}
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1:] @ params["lm_head"], cache


def _cache_attention(q, k_cache, v_cache, kpos, pos, window: int):
    """One query step against a cache; ``kpos`` (S,) shared by the batch or
    (B, S) per row, ``pos`` a scalar or (B,) positions."""
    scale = attn_lib.softmax_scale(q.shape[-1])
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k_cache.float()) * scale
    kp = kpos if kpos.dim() == 2 else kpos[None]
    ps = pos.reshape(-1, 1)
    ok = (kp >= 0) & (kp <= ps)
    if window:
        ok &= kp > ps - window
    logits = torch.where(ok[:, None, None, None, :], logits, attn_lib.NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float()).to(q.dtype)


def _attn_decode(p: Params, x: torch.Tensor, lc: Params, cfg: ModelConfig,
                 pos: torch.Tensor, window: int) -> torch.Tensor:
    """One-token attention layer step; writes the new key/value and its
    position into the layer cache ``lc`` in place (slot = pos % eff)."""
    b = x.shape[0]
    y = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    posv = pos.reshape(-1, 1)
    q, k, v = _qkv(p, y, cfg, posv)
    eff = lc["k"].shape[1]
    slot = pos % eff
    if lc["kpos"].dim() == 1:  # one position for the whole batch
        lc["k"][:, slot] = k[:, 0]
        lc["v"][:, slot] = v[:, 0]
        lc["kpos"][slot] = pos.to(torch.int32)
    else:  # a position per row (the slot pool)
        rows = torch.arange(b, device=x.device)
        lc["k"][rows, slot] = k[:, 0]
        lc["v"][rows, slot] = v[:, 0]
        lc["kpos"][rows, slot] = pos.to(torch.int32)
    o = _cache_attention(q, lc["k"], lc["v"], lc["kpos"], pos, window)
    x = x + o.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]
    return _ffn(p, x, cfg)


def decode_step(params: Params, token: torch.Tensor, cache: Params, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One decode step: token (B, 1) at absolute position ``pos`` (a scalar,
    or (B,) positions for a cache whose kpos is (n_layers, B, eff)).

    Returns (logits (B, 1, V), cache); the cache is updated IN PLACE (the
    reference donates it to the same effect)."""
    check_supported(cfg)
    x = _embed(params, token, cfg)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    window = cfg.sliding_window or cfg.long_context_window or 0
    lcache = cache["blocks"][LAYER]
    for i in range(num_layers(params)):
        x = _attn_decode(layer_params(params, i), x, {k: t[i] for k, t in lcache.items()},
                         cfg, pos, window)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"], cache

