"""The model families of the reference's unified model stack
(``repro.models.transformer``), on tensors.

embed / frontend → layers → final norm → lm head.  Layer kinds
(``ModelConfig.layer_kind``):
  ``attn`` — GQA + RoPE (optional qk-norm / sliding or local window) + FFN
             (SwiGLU dense, or the top-k MoE of :mod:`.moe`);
  ``ssm``  — the Mamba-2 SSD mixer of :mod:`.ssm` (no FFN);
  ``rec``  — the RecurrentGemma block: conv1d + RG-LRU (:mod:`.rglru`),
             gated by a GeLU branch, then a GeGLU FFN.

Layers come in groups (:func:`layer_groups`): one pattern (a single kind,
or a hybrid pattern such as ``(rec, rec, attn)``) repeated ``n_super``
times, then an unrolled tail of the remaining layers.  Parameters are the
reference's tree: ``{"blocks": {"p{i}_{kind}": {...}}, "embed",
"final_norm", "lm_head", "tail": [{...}, ...]}`` with every block leaf
stacked ``(n_super, ...)``, the same shapes (``x @ w`` with ``w`` (in,
out)) and dtypes (the SSM's ``A_log`` / ``dt_bias`` / ``D_skip`` and the
RG-LRU's ``b_a`` / ``b_x`` / ``lam`` are float32 in a bfloat16 model).
Every dict is built with its keys in sorted order, so
:func:`repro_torch.tree.ravel` (insertion order) lays the coordinates out
as ``jax.flatten_util.ravel_pytree`` does (sorted keys): the adapter's
(m, D) gradient rows, the codecs' coordinate maps and the served
iterate's sha256 depend on it.  Caches mirror the tree (``blocks``
stacked, ``tail`` a list).

Frontends are the reference's stubs: precomputed frame or patch
embeddings ``frontend`` (B, T, D) in the model's dtype.  ``audio``
(whisper): an encoder (``enc_blocks``, non-causal attention layers over
the frames plus a sinusoidal table, then ``enc_norm``) whose output every
super-block's attention layer reads through cross-attention
(``cross_blocks``, stacked (n_super, ...); only their ``ln1``/``wq``/``wk``/
``wv``/``wo`` are used, so the gradient of their FFN leaves is exactly 0).
``vision`` (internvl2): the patches are a prefix before the tokens,
stripped before the lm head.  A frontend configuration without its
``frontend`` input raises, as the reference's asserts do.

Tensor parallelism: the entry points take a
:class:`~repro_torch.models.sharding.ShardCtx` (``ctx=``; default
:data:`~repro_torch.models.sharding.NULL_CTX`, every operation the
identity).  At model size M > 1 each weight the partition rules split is
the rank's shard (the global view in process, whose model ranks run one
after the other), and the layers compute as the module doc of
:mod:`repro_torch.models.sharding` sets out: column-parallel q/k/v and
row-parallel ``wo`` on each rank's kv heads (whole ones where the kv heads
divide; else ceil(kv / M) a rank as GSPMD pads them, one all-to-all
bringing a rank its heads' columns and one its ``wo`` rows; the leaves
gathered where the reference replicates the kv heads), column/row-parallel FFN and GeGLU, expert-parallel (else
F-split) MoE, the ``ssm`` mixer on each rank's heads (one all-to-all of
the packed in-projection's columns; gathered where the heads do not
divide) and the ``rec`` mixer on each rank's channels (the conv output
gathered for the gates), each with a row-parallel out-projection, the
encoder and cross-attention in their
own attention mode, a vocab-parallel embedding and cross-entropy (or a
d_model split).  ``prefill`` and ``decode_step`` serve under a model axis
too, a frontend configuration's cross caches on each rank's kv heads in
``heads`` mode.  Under the context's ``seq_parallel`` the residual is
split over the model axis along S between the layers of the ``blocks``
super-blocks (the embedding, the encoder, the tail and the head take it
whole, as the reference constrains it only inside its block scan): each
layer's norm runs on a rank's rows (its scale's gradient taken over the
whole rows) and its model-axis boundaries are the context's ``sp_enter`` /
``sp_reduce``; the function is unchanged, bit for bit.

Activation checkpointing (``remat``, the reference's default ``True``):
``forward`` and ``loss_fn`` run each super-block of the ``blocks`` group,
FSDP's ``block_provider`` gather included, and each encoder layer under
``torch.utils.checkpoint`` when autograd records, so their activations
and gathered weights are recomputed in the backward instead of kept.  The
tail layers are not checkpointed, as in the reference.

Entry points:
  init_params(cfg, seed, device)             -> params tree
  forward(params, tokens, cfg, frontend=, ctx=, remat=)
                                             -> (logits, aux)
  loss_fn(params, batch, cfg, ctx=, remat=)  -> scalar loss (batch["frontend"])
  prefill(params, tokens, cfg, frontend=, cache_len=, ctx=)
                                             -> (last-token logits, cache)
  decode_step(params, token, cache, pos, cfg, ctx=) -> (logits, cache), the
                                                cache updated in place
"""
from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import rng, trace
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import resolve
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.sharding import HEAD_MODES, NULL_CTX, ShardCtx, kv_heads, seq_ok

Params = Dict[str, Any]


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# structure and init
# ---------------------------------------------------------------------------


def layer_groups(cfg: ModelConfig):
    """([(pattern, n_super)], tail kinds): the pattern repeated n_super times,
    then the layers left over, unrolled."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    if not cfg.hybrid_pattern:
        return [((kinds[0],), cfg.n_layers)], []
    plen = len(cfg.hybrid_pattern)
    n_super = cfg.n_layers // plen
    return [(tuple(cfg.hybrid_pattern), n_super)], kinds[n_super * plen:]


class Where(NamedTuple):
    """A layer's place in the tree: ``blocks[key]`` at super-block ``s``, or
    ``tail[key]`` (``s`` None)."""

    part: str
    key: Any
    s: Optional[int]
    kind: str


def layer_slots(cfg: ModelConfig) -> List[Where]:
    """Every layer in execution order: the super-blocks, then the tail."""
    [(pattern, n_super)], tail = layer_groups(cfg)
    out = [Where("blocks", f"p{i}_{kind}", s, kind)
           for s in range(n_super) for i, kind in enumerate(pattern)]
    return out + [Where("tail", j, None, kind) for j, kind in enumerate(tail)]


def layer_at(tree: Params, where: Where) -> Params:
    """One layer's leaves of a params or cache tree: views of the stacked
    blocks (or the s-th entry where a block leaf is a sequence of per-layer
    tensors, as the adapter and the trainer differentiate it, so that each
    layer's gradient comes out at its own size), or the tail's dict."""
    if where.part == "tail":
        return tree["tail"][where.key]
    return _stacked_at(tree["blocks"][where.key], where.s)


def _stacked_at(group: Params, s: int) -> Params:
    """Layer ``s`` of a stacked group (views, or the s-th of per-layer
    tensors as the trainer differentiates them)."""
    return {k: v[s] for k, v in group.items()}


class Spec(NamedTuple):
    """A parameter leaf: N(0, std^2) draws where ``std`` > 0, else filled
    with ``fill``; float32 where ``f32``, else the model's dtype."""

    shape: Tuple[int, ...]
    std: float = 0.0
    fill: float = 0.0
    f32: bool = False


def _attn_specs(cfg: ModelConfig, std: float, out_std: float) -> Dict[str, Spec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {"ln1": Spec((d,)), "ln2": Spec((d,)),
             "wq": Spec((d, h * hd), std), "wk": Spec((d, kv * hd), std),
             "wv": Spec((d, kv * hd), std), "wo": Spec((h * hd, d), out_std)}
    if cfg.qk_norm:
        specs["q_norm"] = Spec((hd,))
        specs["k_norm"] = Spec((hd,))
    if cfg.moe is not None:
        e, fe = cfg.moe.num_experts, cfg.moe.d_expert
        specs["router"] = Spec((d, e), std)
        specs["we_g"] = Spec((e, d, fe), std)
        specs["we_u"] = Spec((e, d, fe), std)
        specs["we_d"] = Spec((e, fe, d), out_std)
    elif cfg.d_ff:
        specs["wg"] = Spec((d, cfg.d_ff), std)
        specs["wu"] = Spec((d, cfg.d_ff), std)
        specs["wd"] = Spec((cfg.d_ff, d), out_std)
    return specs


def _ssm_dims(cfg: ModelConfig):
    """(SSMConfig, d_inner, heads, conv channels)."""
    s = cfg.ssm or SSMConfig()
    di = s.expand * cfg.d_model
    return s, di, di // s.head_dim, di + 2 * s.d_state


def _ssm_specs(cfg: ModelConfig, std: float, out_std: float) -> Dict[str, Spec]:
    s, di, nheads, conv_dim = _ssm_dims(cfg)
    d = cfg.d_model
    return {"ln1": Spec((d,)),
            "w_in": Spec((d, 2 * di + 2 * s.d_state + nheads), std),
            "conv_w": Spec((s.conv_width, conv_dim), std),
            "A_log": Spec((nheads,), f32=True),  # A = -exp(A_log) = -1
            "dt_bias": Spec((nheads,), fill=-2.0, f32=True),
            "D_skip": Spec((nheads,), fill=1.0, f32=True),
            "out_norm": Spec((di,)),
            "w_out": Spec((di, d), out_std)}


def _rec_specs(cfg: ModelConfig, std: float, out_std: float) -> Dict[str, Spec]:
    d = c = cfg.d_model  # the LRU's width is d_model
    return {"ln1": Spec((d,)), "ln2": Spec((d,)),
            "w_bx": Spec((d, c), std), "w_bg": Spec((d, c), std),
            "conv_w": Spec((4, c), std),
            "w_a": Spec((c, c), std), "b_a": Spec((c,), f32=True),
            "w_xg": Spec((c, c), std), "b_x": Spec((c,), f32=True),
            "lam": Spec((c,), fill=0.5, f32=True),
            "w_ro": Spec((c, d), out_std),
            "wg": Spec((d, cfg.d_ff), std), "wu": Spec((d, cfg.d_ff), std),
            "wd": Spec((cfg.d_ff, d), out_std)}


_SPECS = {"attn": _attn_specs, "ssm": _ssm_specs, "rec": _rec_specs}


def _layer_specs(kind: str, cfg: ModelConfig) -> Dict[str, Spec]:
    std = 0.02
    specs = _SPECS[kind](cfg, std, std / math.sqrt(2.0 * cfg.n_layers))
    return dict(sorted(specs.items()))


def _stacked(specs: Dict[str, Spec], n: int) -> Dict[str, Spec]:
    return {k: sp._replace(shape=(n,) + sp.shape) for k, sp in specs.items()}


def _param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree as :class:`Spec` leaves, keys sorted at every level.

    The encoder and cross layers are attention layers of the reference's
    ``enc_cfg`` (no MoE, no qk-norm), FFN leaves included."""
    [(pattern, n_super)], tail = layer_groups(cfg)
    blocks = {f"p{i}_{kind}": _stacked(_layer_specs(kind, cfg), n_super)
              for i, kind in enumerate(pattern)}
    tree = {"blocks": dict(sorted(blocks.items())),
            "embed": Spec((cfg.vocab, cfg.d_model), 0.02),
            "final_norm": Spec((cfg.d_model,)),
            "lm_head": Spec((cfg.d_model, cfg.vocab), 0.02)}
    if tail:
        tree["tail"] = [_layer_specs(kind, cfg) for kind in tail]
    if cfg.n_enc_layers:
        enc = _layer_specs("attn", _enc_cfg(cfg))
        tree["enc_blocks"] = _stacked(enc, cfg.n_enc_layers)
        tree["enc_norm"] = Spec((cfg.d_model,))
        if cfg.cross_attention:
            tree["cross_blocks"] = _stacked(enc, n_super)
    return dict(sorted(tree.items()))


def _map_specs(fn, tree, path=""):
    if isinstance(tree, Spec):
        return fn(path, tree)
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, list):
        return [_map_specs(fn, v, join(i)) for i, v in enumerate(tree)]
    return {k: _map_specs(fn, v, join(k)) for k, v in tree.items()}


def _leaf_dtype(cfg: ModelConfig, spec: Spec) -> torch.dtype:
    return torch.float32 if spec.f32 else _dt(cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters: N(0, std^2) in float32 cast to the leaf's dtype,
    or the reference's constants (zero norm scales, A_log 0, dt_bias -2,
    D_skip 1, lam 0.5), each drawn leaf on ``device`` from a generator
    seeded with (seed, leaf path).  The draws differ from the reference's
    threefry and between devices; parity tests convert the reference's
    parameters instead (:mod:`repro_torch.models.convert`)."""
    dev = resolve(device)

    def leaf(path, spec):
        dtype = _leaf_dtype(cfg, spec)
        if spec.std == 0.0:
            return torch.full(spec.shape, spec.fill, dtype=dtype, device=dev)
        g = rng.generator(seed, zlib.crc32(path.encode()), device=dev)
        x = torch.randn(spec.shape, generator=g, dtype=torch.float32, device=dev)
        return x.mul_(spec.std).to(dtype)

    return _map_specs(leaf, _param_specs(cfg))


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as ``(shape, dtype)`` leaves, nothing allocated."""
    return _map_specs(lambda path, spec: (spec.shape, _leaf_dtype(cfg, spec)),
                      _param_specs(cfg))


def meta_params(cfg: ModelConfig) -> Params:
    """The parameter tree as tensors on the meta device: shapes and dtypes,
    nothing allocated."""
    return _map_specs(lambda path, spec: torch.empty(spec.shape, dtype=_leaf_dtype(cfg, spec),
                                                     device="meta"), _param_specs(cfg))


def count_params(cfg: ModelConfig) -> int:
    total = 0

    def add(path, spec):
        nonlocal total
        total += math.prod(spec.shape)

    _map_specs(add, _param_specs(cfg))
    return total


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token: an MoE counts top_k of num_experts."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    e, k, fe, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert, cfg.d_model
    return total - cfg.n_layers * e * 3 * d * fe + cfg.n_layers * k * 3 * d * fe


# ---------------------------------------------------------------------------
# layers over a full sequence (train / prefill)
# ---------------------------------------------------------------------------


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of the encoder and cross-attention layers (the
    reference's ``enc_cfg``: no MoE, no qk-norm)."""
    return dataclasses.replace(cfg, moe=None, qk_norm=False)


def _remat(fn: Callable, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    autograd records: the activations inside are recomputed in the
    backward, not kept.  The layers draw no random numbers, so the RNG
    state is not stashed (stashing it would read the card's state)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _on(ctx: ShardCtx, split: bool) -> ShardCtx:
    """The context a layer computes under: ``ctx`` where the model axis
    splits its leaves, else :data:`NULL_CTX` (one rank, the whole leaf)."""
    return ctx if split else NULL_CTX


def _norm(ctx: ShardCtx, x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``rms_norm(x, w)`` of a block's residual; under ``ctx.seq_parallel``
    a rank's rows at a time (:func:`_rows_norm`)."""
    if not ctx.seq_parallel:
        return L.rms_norm(x, w, eps)
    return _rows_norm(ctx, x, w, eps)


def _rows_norm(ctx: ShardCtx, x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``rms_norm(x, w)`` of the blocks' residual (``ctx.seq_len`` rows of
    S) normalized a model rank's rows at a time, its scale's gradient
    summed over the whole rows.  On a process group ``x`` is the rank's
    rows, padded past the end, and the scale's gradient gathers the
    ranks' rows (:meth:`~repro_torch.core.distributed.Collectives.seq_scale`);
    in process ``x`` is the whole residual, normalized in the ranks'
    chunks of rows, so that each row takes the autograd path it takes on
    its rank and the bits are the process group's."""
    ax, n = ctx.axes, ctx.seq_len
    c = -(-n // ctx.model)
    t = 1.0 + w.float()
    if ax.holds_shards:
        real = max(0, min(c, n - ax.model_ranks()[0] * c))
        y = ax.seq_scale(L.rms_normalize(x.narrow(1, 0, real), eps), t, 1, n).to(x.dtype)
        return y if real == c else torch.cat([y, y.new_zeros(
            (y.shape[0], c - real) + tuple(y.shape[2:]))], 1)
    xh = torch.cat([L.rms_normalize(x.narrow(1, a, min(c, n - a)), eps)
                    for a in range(0, n, c)], 1)
    return ax.seq_scale(xh, t, 1, n).to(x.dtype)


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
           ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """Token embeddings (B, S, D).  With V split each rank looks up the
    tokens of its vocab range (the others read 0) and the lookups are
    psummed: one non-zero term per element, so the sum is exact; with D
    split (or nothing) each rank looks up its columns and they are
    gathered."""
    split = ctx.modes(cfg).embed
    c = _on(ctx, split is not None)
    w, tok = params["embed"], tokens.long()
    if split != 0:
        return c.cat([F.embedding(tok, c.shard(w, 1, k)) for k in c.ranks()], -1).to(_dt(cfg))
    vl = cfg.vocab // c.model
    parts = []
    for k in c.ranks():
        t = tok - k * vl
        ok = (t >= 0) & (t < vl)
        e = F.embedding(torch.where(ok, t, torch.zeros_like(t)), c.shard(w, 0, k))
        parts.append(torch.where(ok[..., None], e, torch.zeros_like(e)))
    return c.reduce(parts).to(_dt(cfg))


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
         ctx: ShardCtx = NULL_CTX) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention layer's FFN half -> (x, the MoE's aux loss or 0).
    Split on F: column-parallel ``wg``/``wu``, row-parallel ``wd``, the
    ranks' partial outputs psummed."""
    y = _norm(ctx, x, p["ln2"], cfg.norm_eps)
    modes = ctx.modes(cfg)
    if cfg.moe is not None:
        router = p["router"]
        if modes.router is not None:
            router = ctx.full(router, modes.router)
        f, aux = moe_lib.moe_ffn(y, router, p["we_g"], p["we_u"], p["we_d"],
                                 cfg.moe.top_k, ctx=ctx, split=modes.moe)
        return x + f, aux
    if cfg.d_ff:
        c = _on(ctx, modes.ffn)
        ye = ctx.sp_enter(c, y)
        parts = []
        for k in c.ranks():
            wg, wu, wd = c.shard(p["wg"], 1, k), c.shard(p["wu"], 1, k), c.shard(p["wd"], 0, k)
            yk = c.local(ye, k)
            parts.append((F.silu(yk @ wg) * (yk @ wu)) @ wd)
        x = x + ctx.sp_reduce(c, parts)
    return x, _zero(x)


# ---------------------------------------------------------------------------
# attention on the model axis
# ---------------------------------------------------------------------------

_ATTN_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}  # the split dim of a layer's leaf
_QKV = ("wq", "wk", "wv")


def _attn_ctx(ctx: ShardCtx, cfg: ModelConfig) -> ShardCtx:
    """The context attention computes under in ``cfg``'s mode: ``ctx`` in
    ``heads`` and ``padded`` modes (each model rank its kv heads), else one
    rank (nothing split, or the leaves gathered by :func:`_gathered`)."""
    return _on(ctx, ctx.modes(cfg).attn in HEAD_MODES)


def _gathered(p: Params, cfg: ModelConfig, ctx: ShardCtx, names=tuple(_ATTN_DIMS)) -> Params:
    """``p`` with its split attention leaves among ``names`` gathered whole
    in ``gathered`` mode; as it is in the other modes."""
    modes = ctx.modes(cfg)
    if modes.attn != "gathered":
        return p
    return dict(p, **{n: ctx.full(p[n], _ATTN_DIMS[n]) for n in modes.attn_split if n in names})


def _per_head(cfg: ModelConfig, name: str) -> int:
    """The columns of one kv head in the product by leaf ``name`` (its query
    group's for ``wq``, and ``wo``'s rows)."""
    return cfg.hd * (cfg.n_heads // cfg.n_kv_heads if name in ("wq", "wo") else 1)


@functools.lru_cache(maxsize=None)
def _padded_wants(cfg: ModelConfig, model: int, names: Tuple[str, ...]):
    """The all-to-all of ``padded`` mode's projections: each rank holds its
    even chunks of the leaves ``names`` (or their products) side by side,
    and rank ``k`` wants the columns of its kv heads
    (:func:`~repro_torch.models.sharding.kv_heads`) of each, which may
    straddle chunks.  -> (per rank its (start, stop) ranges of the ranks'
    packed chunks end to end, ascending; per rank the received pieces in
    that order as (index in ``names``, width))."""
    widths = [_per_head(cfg, n) * cfg.n_kv_heads // model for n in names]  # a chunk's
    whole = sum(widths)
    offs = [sum(widths[:i]) for i in range(len(widths))]
    wants, pieces = [], []
    for k in range(model):
        h0, h1 = kv_heads(cfg.n_kv_heads, model, k)
        got = []
        for i, (name, w) in enumerate(zip(names, widths)):
            a, b = h0 * _per_head(cfg, name), h1 * _per_head(cfg, name)
            while a < b:  # a piece a source chunk
                src = a // w
                e = min(b, (src + 1) * w)
                at = src * whole + offs[i] + a - src * w
                got.append((at, at + e - a, i))
                a = e
        got.sort()
        wants.append(tuple((a, b) for a, b, _ in got))
        pieces.append(tuple((i, b - a) for a, b, i in got))
    return tuple(wants), tuple(pieces)


def _moves_weights(x: torch.Tensor, cfg: ModelConfig) -> bool:
    """Whether ``padded`` mode moves the weights' columns (and ``wo``'s
    rows) rather than the activations' for an input ``x`` (.., D): a rank's
    heads take as many columns of either, D rows of the weights against
    the tokens' rows of the products, so the weights travel once the
    tokens outnumber d_model (training and prefill), the products below
    (decode)."""
    return math.prod(x.shape[:-1]) > cfg.d_model


def _on_heads(c: ShardCtx, cfg: ModelConfig, x: torch.Tensor, p: Params, names) -> list:
    """The products of ``x`` (entered: each rank reads it through its own
    ``local``) by the leaves ``names``, on each rank's kv heads: per rank of
    ``c.ranks()`` a list with one (.., its heads' columns) tensor a name.
    In ``heads`` mode (and on one rank) each rank multiplies by its chunks
    of the leaves, which are its heads'.  In ``padded`` mode one
    all-to-all (:meth:`ShardCtx.columns`) hands every rank its heads'
    columns, zero wide on a rank with none: of the chunks of the leaves
    side by side, which it then multiplies by, or of the products by its
    chunks side by side, whichever is smaller (:func:`_moves_weights`)."""
    ranks = c.ranks()
    if c.modes(cfg).attn != "padded":
        parts = []
        for r in ranks:
            xl = c.local(x, r)
            parts.append([xl @ c.shard(p[n], 1, r) for n in names])
        return parts
    wants, pieces = _padded_wants(cfg, c.model, tuple(names))
    packed = [torch.cat([c.shard(p[n], 1, r) for n in names], -1) for r in ranks]
    if _moves_weights(x, cfg):
        got = [c.local(x, r) @ w for r, w in zip(ranks, c.columns(packed, -1, wants))]
    else:
        got = c.columns([c.local(x, r) @ w for r, w in zip(ranks, packed)], -1, wants)
    out = []
    for r, g in zip(ranks, got):
        per = [[] for _ in names]
        if pieces[r]:
            for (i, _), t in zip(pieces[r], torch.split(g, [n for _, n in pieces[r]], -1)):
                per[i].append(t)
        out.append([torch.cat(ts, -1) if len(ts) > 1 else ts[0] if ts else g.narrow(-1, 0, 0)
                    for ts in per])
    return out


def _kv_split(t: torch.Tensor, hd: int) -> torch.Tensor:
    """Keys or values (.., KV_r·hd) as (.., KV_r, hd)."""
    return t.reshape(t.shape[:-1] + (t.shape[-1] // hd, hd))


def _to_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
              positions: Optional[torch.Tensor] = None, norms: Optional[Params] = None):
    """A rank's projections (.., its kv heads' columns) as q (B, S, KV_r, G,
    hd) and k, v (B, T, KV_r, hd); qk-normed by ``norms``' scales under
    ``cfg.qk_norm`` and rotated at ``positions`` (None: neither, the
    cross-attention's).  A rank with no kv heads gets zero-size heads."""
    hd, g = cfg.hd, cfg.n_heads // cfg.n_kv_heads
    k, v = _kv_split(k, hd), _kv_split(v, hd)
    nk = k.shape[-2]
    q = q.reshape(q.shape[:-1] + (nk, g, hd))
    if positions is None:
        return q, k, v
    if cfg.qk_norm:
        q = L.rms_norm(q, norms["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, norms["k_norm"], cfg.norm_eps)
    b, s = q.shape[:2]
    q = L.rope(q.reshape(b, s, nk * g, hd), positions, cfg.rope_theta).reshape(b, s, nk, g, hd)
    return q, L.rope(k, positions, cfg.rope_theta), v


def _wo_parts(c: ShardCtx, cfg: ModelConfig, outs: list, wo: torch.Tensor) -> list:
    """The ranks' partial outputs by their rows of ``wo`` (row-parallel), to
    be summed in rank order, from their attention outputs ``outs`` (.., their
    heads' columns).  In ``heads`` mode (and on one rank) a rank's chunk of
    ``wo`` is its heads' rows.  In ``padded`` mode one all-to-all hands
    every rank either its heads' rows of ``wo`` (a rank with none adds a
    zero partial) or, where the outputs are the smaller message
    (:func:`_moves_weights`), the outputs' columns of its even chunk of
    ``wo``'s rows, each output padded to ceil(kv / M) kv heads' columns as
    GSPMD pads the heads (the padding is no rank's)."""
    ranks = c.ranks()
    chunks = [c.shard(wo, 0, r) for r in ranks]
    if c.modes(cfg).attn != "padded":
        return [o @ w for o, w in zip(outs, chunks)]
    if _moves_weights(outs[0], cfg):
        wants, _ = _padded_wants(cfg, c.model, ("wo",))
        return [o @ w for o, w in zip(outs, c.columns(chunks, 0, wants))]
    width = -(-cfg.n_kv_heads // c.model) * _per_head(cfg, "wo")
    rows = cfg.n_heads * cfg.hd // c.model
    cols = c.columns([F.pad(o, (0, width - o.shape[-1])) for o in outs], -1,
                     tuple(((k * rows, (k + 1) * rows),) for k in range(c.model)))
    return [o @ w for o, w in zip(cols, chunks)]


def _flat_heads(o: torch.Tensor) -> torch.Tensor:
    """An attention output (B, S, KV_r, G, hd) as (B, S, KV_r·G·hd), zero
    wide on a rank with no kv heads."""
    return o.reshape(o.shape[:2] + (math.prod(o.shape[2:]),))


def _cross_attention(cp: Params, x: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
                     kv_block: int, ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """One block's cross-attention output (B, S, D), added to ``x`` by the
    caller.  The cross leaves are the encoder config's attention leaves, so
    they take its mode: in ``heads`` and ``padded`` each model rank
    projects its kv heads of the normed ``x`` and of the encoder output
    (both entered: every rank holds them alike, their gradients are the
    ranks' summed; in ``padded`` one all-to-all each) and attends with
    them, ``wo`` row-parallel (:func:`_wo_parts`), the partials summed; in
    ``gathered`` the split leaves are gathered whole."""
    ecfg = _enc_cfg(cfg)
    cp = _gathered(cp, ecfg, ctx)
    c = _attn_ctx(ctx, ecfg)
    ye, ee = ctx.sp_enter(c, _norm(ctx, x, cp["ln1"], cfg.norm_eps)), c.enter(enc_out)
    outs = []
    for (q,), (k, v) in zip(_on_heads(c, ecfg, ye, cp, ("wq",)),
                            _on_heads(c, ecfg, ee, cp, ("wk", "wv"))):
        outs.append(_flat_heads(attn_lib.attention(*_to_heads(q, k, v, ecfg), causal=False,
                                                   kv_block=kv_block)))
    return ctx.sp_reduce(c, _wo_parts(c, ecfg, outs, cp["wo"]))


def _attn_layer_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
                    window: int = 0, positions: Optional[torch.Tensor] = None,
                    kv_block: int = 1024, enc_out: Optional[torch.Tensor] = None,
                    cross_p: Optional[Params] = None, ctx: ShardCtx = NULL_CTX):
    """One attention layer over a full sequence x (B, S, D) -> (x, aux, (k, v)).

    With ``enc_out`` and ``cross_p`` it attends to the encoder output
    (non-causal) between its self-attention and its FFN
    (:func:`_cross_attention`).  Under ``ctx``'s ``heads`` and ``padded``
    modes each model rank projects, rotates and attends its own kv heads
    (:func:`_on_heads`: in ``padded`` one all-to-all of the weights' or the
    products' columns), and ``wo`` is row-parallel (:func:`_wo_parts`: in
    ``padded`` one all-to-all of its rows or of the output's columns), the
    partial outputs psummed; each rank's heads are normed by the replicated
    qk-norm scales read through an enter (their gradient the ranks'
    summed).  Under ``gathered`` the split leaves are gathered whole.  The
    returned k, v are the ranks' this process computes, their kv heads
    concatenated in rank order (in process every rank's: the whole heads;
    under a process group the rank's own, zero wide past the last kv
    head).  Under the context's ``seq_parallel`` ``x`` is a rank's rows of
    the residual and so is the result."""
    y = _norm(ctx, x, p["ln1"], cfg.norm_eps)
    p = _gathered(p, cfg, ctx)
    c = _attn_ctx(ctx, cfg)
    ye = ctx.sp_enter(c, y)
    if positions is None:
        positions = torch.arange(ye.shape[1], device=x.device)[None, :]
    norms = _entered(p, ("k_norm", "q_norm"), c) if cfg.qk_norm else {}
    outs, ks, vs = [], [], []
    for r, (q, k, v) in zip(c.ranks(), _on_heads(c, cfg, ye, p, _QKV)):
        q, k, v = _to_heads(q, k, v, cfg, positions,
                            {n: c.local(w, r) for n, w in norms.items()})
        outs.append(_flat_heads(attn_lib.attention(q, k, v, causal=causal, window=window,
                                                   kv_block=kv_block)))
        ks.append(k)
        vs.append(v)
    x = x + ctx.sp_reduce(c, _wo_parts(c, cfg, outs, p["wo"]))
    k, v = (torch.cat(ks, 2), torch.cat(vs, 2)) if len(ks) > 1 else (ks[0], vs[0])
    if enc_out is not None and cross_p is not None:
        x = x + _cross_attention(cross_p, x, enc_out, cfg, kv_block, ctx)
    x, aux = _ffn(p, x, cfg, ctx)
    return x, aux, (k, v)


def _gather_in(p: Params, cfg: ModelConfig, ctx: ShardCtx) -> Params:
    """An ``ssm`` layer's leaves in the mixer's ``gathered`` mode, with the
    packed in-projection the model axis splits gathered whole: the mixer
    then runs whole on every rank."""
    names = ctx.modes(cfg).mixer_in
    return dict(p, **{n: ctx.full(p[n], 1) for n in names if n in p}) if names else p


def _row_parallel(y: torch.Tensor, w: torch.Tensor, split: bool, ctx: ShardCtx) -> torch.Tensor:
    """``y @ w`` with ``w`` split on its rows over the model axis (``split``):
    each rank multiplies its chunk of ``y``'s last dim by its rows of ``w``
    and the partials are summed in rank order.  Every rank computes ``y``
    alike from whole leaves, so it is entered first: its gradient is then
    the ranks' summed, the whole gradient every rank's gathered leaves
    take their chunk of."""
    c = _on(ctx, split)
    ye = c.enter(y)
    return ctx.sp_reduce(c, [c.split(c.local(ye, r), -1, r) @ c.shard(w, 0, r)
                             for r in c.ranks()])


def _entered(p: Params, names, c: ShardCtx) -> Params:
    """Replicated per-head or per-channel leaves a rank reads its entries
    of: entered, so that their gradient is the ranks' summed."""
    return {n: c.enter(p[n]) for n in names}


def _ssm_in(p: Params, x: torch.Tensor, cfg: ModelConfig, prev: Optional[torch.Tensor],
            ctx: ShardCtx = NULL_CTX):
    """The SSM layer's input side, whole on every rank: (z, the dt-scaled
    heads x·dt, x, loga, B, C, the conv's new window); the mixer reads
    every position, so a rank's rows under ``seq_parallel`` are gathered
    after the norm."""
    s_cfg, di, nheads, _ = _ssm_dims(cfg)
    n = s_cfg.d_state
    y = ctx.sp_enter(NULL_CTX, _norm(ctx, x, p["ln1"], cfg.norm_eps))
    z, xs, bm, cm, dt = torch.split(y @ p["w_in"], [di, di, n, n, nheads], dim=-1)
    conv_out, conv_state = ssm_lib.causal_conv1d(torch.cat([xs, bm, cm], dim=-1),
                                                 p["conv_w"], prev)
    xs, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    loga = -torch.exp(p["A_log"]) * dt
    xh = xs.reshape(xs.shape[:2] + (nheads, s_cfg.head_dim))
    return z, xh * dt[..., None].to(xh.dtype), xh, loga, bm, cm, conv_state


def _ssm_out(p: Params, x: torch.Tensor, y_ssd: torch.Tensor, xh: torch.Tensor,
             z: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx) -> torch.Tensor:
    y_ssd = y_ssd + p["D_skip"][:, None].to(y_ssd.dtype) * xh
    y_out = y_ssd.reshape(z.shape) * F.silu(z)
    y_out = L.rms_norm(y_out, p["out_norm"], cfg.norm_eps)
    return x + _row_parallel(y_out, p["w_out"], "w_out" in ctx.modes(cfg).mixer_out, ctx)


def _ssm_cols(cfg: ModelConfig, model: int):
    """Each model rank's columns of the packed in-projection in the mixer's
    ``heads`` mode, as (start, stop) ranges: its heads' z and x, B and C
    whole, its heads' dt."""
    s_cfg, di, nheads, _ = _ssm_dims(cfg)
    cd, ch, bc = di // model, nheads // model, 2 * di + 2 * s_cfg.d_state
    return [((k * cd, (k + 1) * cd), (di + k * cd, di + (k + 1) * cd), (2 * di, bc),
             (bc + k * ch, bc + (k + 1) * ch)) for k in range(model)]


def _ssm_heads(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx,
               lc: Optional[Params] = None):
    """An SSM layer in the mixer's ``heads`` mode -> (x, the state this
    process holds): a full sequence, or with the layer cache ``lc`` one
    decode step, which updates ``lc`` in place.

    Each model rank multiplies the normed input by its chunk of ``w_in``,
    and one all-to-all (:meth:`ShardCtx.columns`) hands every rank its
    heads' z, x and dt columns and the B and C columns whole.  The conv
    runs on the rank's x channels and B and C, the SSD on its heads, and
    ``out_norm``'s mean square is the ranks' sums of squares summed in rank
    order; ``w_out`` is row-parallel.  The state is the rank's heads of
    ``ssd`` and its conv window of x, B and C
    (:class:`~repro_torch.models.sharding.HeadsConv`); in process each
    rank's in turn of the whole (the global view), the B and C window
    written once."""
    s_cfg, di, nheads, _ = _ssm_dims(cfg)
    n, hd = s_cfg.d_state, s_cfg.head_dim
    model, ranks = ctx.model, ctx.ranks()
    cd, ch = di // model, nheads // model
    whole = len(ranks) > 1  # in process: every rank of a whole cache
    ye = ctx.sp_enter(ctx, _norm(ctx, x, p["ln1"], cfg.norm_eps))
    cols = ctx.columns([ctx.local(ye, k) @ ctx.shard(p["w_in"], 1, k) for k in ranks], -1,
                       _ssm_cols(cfg, model))
    e = _entered(p, ("A_log", "D_skip", "conv_w", "dt_bias", "out_norm"), ctx)
    prevs = [None] * len(ranks)
    if lc is not None:
        prevs = [torch.cat([lc["conv"].narrow(-1, k * cd, cd), lc["conv"].narrow(-1, di, 2 * n)],
                           -1) if whole else lc["conv"] for k in ranks]
    ys, sqs, convs, states = [], [], [], []
    for i, k in enumerate(ranks):
        z, xs, bc, dt = torch.split(cols[i], [cd, cd, 2 * n, ch], dim=-1)
        conv_w = ctx.local(e["conv_w"], k)
        wk = torch.cat([conv_w.narrow(1, k * cd, cd), conv_w.narrow(1, di, 2 * n)], 1)
        conv_out, conv_state = ssm_lib.causal_conv1d(torch.cat([xs, bc], -1), wk, prevs[i])
        xs, bm, cm = torch.split(conv_out, [cd, n, n], dim=-1)
        dt = F.softplus(dt.float() + ctx.split(ctx.local(e["dt_bias"], k), 0, k))
        loga = -torch.exp(ctx.split(ctx.local(e["A_log"], k), 0, k)) * dt
        xh = xs.reshape(xs.shape[:2] + (ch, hd))
        xdt = xh * dt[..., None].to(xh.dtype)
        if lc is None:
            y_ssd, state = ssm_lib.ssd_chunked(xdt, loga, bm, cm, chunk=s_cfg.chunk)
        else:
            h0 = lc["ssd"].narrow(1, k * ch, ch) if whole else lc["ssd"]
            y_ssd, state = ssm_lib.ssd_decode_step(h0, xdt[:, 0], loga[:, 0], bm[:, 0],
                                                   cm[:, 0])
            y_ssd = y_ssd[:, None]
        d_skip = ctx.split(ctx.local(e["D_skip"], k), 0, k)
        y = (y_ssd + d_skip[:, None].to(y_ssd.dtype) * xh).reshape(z.shape) * F.silu(z)
        yf = y.float()
        ys.append(y)
        sqs.append(torch.sum(yf * yf, dim=-1, keepdim=True))
        convs.append(conv_state)
        states.append(state)
    ms = ctx.enter(ctx.reduce(sqs))  # the whole row's sum of squares, every rank's
    parts = []
    for i, k in enumerate(ranks):
        scale = 1.0 + ctx.split(ctx.local(e["out_norm"], k), 0, k).float()
        y = ys[i].float() * torch.rsqrt(ctx.local(ms, k) / di + cfg.norm_eps) * scale
        parts.append(y.to(ys[i].dtype) @ ctx.shard(p["w_out"], 0, k))
    x = x + ctx.sp_reduce(ctx, parts)
    if whole:
        conv = torch.cat([c.narrow(-1, 0, cd) for c in convs] + [convs[0].narrow(-1, cd, 2 * n)],
                         -1)
        state = {"conv": conv, "ssd": torch.cat(states, 1)}
    else:
        state = {"conv": convs[0], "ssd": states[0]}
    if lc is not None:
        lc["conv"].copy_(state["conv"])
        lc["ssd"].copy_(state["ssd"])
    return x, state


def _ssm_layer_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx = NULL_CTX):
    """One SSM layer over a full sequence -> (x, aux 0, its final state).
    Under a model axis in the mixer's ``heads`` mode on each rank's heads
    (:func:`_ssm_heads`); in ``gathered`` mode the packed in-projection is
    gathered, the conv, the SSD and ``out_norm`` run whole and ``w_out`` is
    row-parallel."""
    if ctx.modes(cfg).ssm == "heads":
        x, state = _ssm_heads(p, x, cfg, ctx)
        return x, _zero(x), state
    p = _gather_in(p, cfg, ctx)
    z, xdt, xh, loga, bm, cm, conv_state = _ssm_in(p, x, cfg, None, ctx)
    y_ssd, state = ssm_lib.ssd_chunked(xdt, loga, bm, cm, chunk=_ssm_dims(cfg)[0].chunk)
    return (_ssm_out(p, x, y_ssd, xh, z, cfg, ctx), _zero(x),
            {"conv": conv_state, "ssd": state})


def _rec_mixer(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx,
               lc: Optional[Params] = None):
    """A recurrent layer -> (x, the state this process holds): a full
    sequence, or with the layer cache ``lc`` one decode step, which
    updates ``lc`` in place.

    In the mixer's ``channels`` mode each model rank computes its channels
    of the branches (``w_bx`` / ``w_bg`` column-parallel) and of the conv;
    the conv output is gathered over the model axis
    (:meth:`ShardCtx.gather`: its gradient reduce-scattered), since the
    gates read every channel, and each rank takes its gate columns of
    ``w_a`` / ``w_xg`` and its entries of ``b_a``, ``b_x`` and ``lam``.
    The scan, its state and ``r · bg`` are on the rank's channels and
    ``w_ro`` is row-parallel; in process each rank's slice of a whole cache
    in turn.  Without that mode the mixer runs whole (one rank).  Then the
    GeGLU, split on F (column-parallel ``wg`` / ``wu``, row-parallel
    ``wd``, as the dense FFN)."""
    c = _on(ctx, ctx.modes(cfg).rec == "channels")
    ranks = c.ranks()
    cc = cfg.d_model // c.model  # the LRU's width is d_model
    whole = len(ranks) > 1
    ye = ctx.sp_enter(c, _norm(ctx, x, p["ln1"], cfg.norm_eps))  # the scan reads all of S
    e = _entered(p, ("b_a", "b_x", "conv_w", "lam"), c)
    bgs, outs, convs = [], [], []
    for k in ranks:
        yk = c.local(ye, k)
        bgs.append(F.gelu(yk @ c.shard(p["w_bg"], 1, k), approximate="tanh"))  # jax's default
        prev = None
        if lc is not None:
            prev = lc["conv"].narrow(-1, k * cc, cc) if whole else lc["conv"]
        out, conv_state = ssm_lib.causal_conv1d(yk @ c.shard(p["w_bx"], 1, k),
                                                c.split(c.local(e["conv_w"], k), 1, k), prev)
        outs.append(out)
        convs.append(conv_state)
    full = c.gather(outs, -1)
    parts, hs = [], []
    for i, k in enumerate(ranks):
        own = outs[i] if c.model > 1 else None  # one rank: the gates' input itself
        gates = (c.shard(p["w_a"], 1, k), c.split(c.local(e["b_a"], k), 0, k),
                 c.shard(p["w_xg"], 1, k), c.split(c.local(e["b_x"], k), 0, k),
                 c.split(c.local(e["lam"], k), 0, k))
        if lc is None:
            r, h = rglru_lib.rglru_scan(c.local(full, k), *gates, own=own)
        else:
            h0 = lc["h"].narrow(-1, k * cc, cc) if whole else lc["h"]
            r, h = rglru_lib.rglru_decode_step(h0, c.local(full, k), *gates, own=own)
        hs.append(h)
        parts.append((r * bgs[i]) @ c.shard(p["w_ro"], 0, k))
    x = x + ctx.sp_reduce(c, parts)
    f = _on(ctx, ctx.modes(cfg).ffn)
    ye = ctx.sp_enter(f, _norm(ctx, x, p["ln2"], cfg.norm_eps))
    x = x + ctx.sp_reduce(f, [L.geglu(f.local(ye, k), f.shard(p["wg"], 1, k),
                                      f.shard(p["wu"], 1, k), f.shard(p["wd"], 0, k))
                              for k in f.ranks()])
    state = {"conv": torch.cat(convs, -1), "h": torch.cat(hs, -1)} if whole else \
        {"conv": convs[0], "h": hs[0]}
    if lc is not None:
        lc["conv"].copy_(state["conv"])
        lc["h"].copy_(state["h"])
    return x, state


def _rec_layer_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx = NULL_CTX):
    """One recurrent layer over a full sequence -> (x, aux 0, its final
    state); under a model axis on each rank's channels
    (:func:`_rec_mixer`)."""
    x, state = _rec_mixer(p, x, cfg, ctx)
    return x, _zero(x), state


def _attn_window(cfg: ModelConfig) -> int:
    """Training/prefill attention window: native SWA, or the hybrid
    pattern's local-attention window (0 = full attention)."""
    if cfg.sliding_window:
        return cfg.sliding_window
    return cfg.local_window if cfg.hybrid_pattern else 0


def _layer_fwd(where: Where, p: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, kv_block: int, cross=None, ctx: ShardCtx = NULL_CTX):
    """-> (x, aux, the layer's state: (k, v) for attention).  ``cross``:
    (the encoder output, this block's cross-attention params) or None."""
    if where.kind == "attn":
        enc_out, cross_p = cross if cross is not None else (None, None)
        return _attn_layer_fwd(p, x, cfg, window=_attn_window(cfg), positions=positions,
                               kv_block=kv_block, enc_out=enc_out, cross_p=cross_p, ctx=ctx)
    if where.kind == "ssm":
        return _ssm_layer_fwd(p, x, cfg, ctx)
    return _rec_layer_fwd(p, x, cfg, ctx)


def _encoder_fwd(params: Params, frontend: torch.Tensor, cfg: ModelConfig,
                 kv_block: int = 1024, ctx: ShardCtx = NULL_CTX,
                 remat: bool = False) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, T, D): the
    sinusoidal table added, ``n_enc_layers`` non-causal attention layers
    of the encoder config (RoPE at the default positions on top of the
    table, as in the reference; under ``ctx`` in the encoder's own
    attention mode), each checkpointed with ``remat``, then ``enc_norm``."""
    ecfg, ctx = _enc_cfg(cfg), ctx.whole()
    x = frontend + L.sinusoidal_positions(frontend.shape[1], cfg.d_model, frontend.dtype,
                                          frontend.device)[None]
    for i in range(cfg.n_enc_layers):
        def layer(x, i=i):
            return _attn_layer_fwd(_stacked_at(params["enc_blocks"], i), x, ecfg, causal=False,
                                   kv_block=kv_block, ctx=ctx)[0]

        x = _remat(layer, remat, x)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _frontend_in(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 frontend: Optional[torch.Tensor], kv_block: int, ctx: ShardCtx = NULL_CTX,
                 remat: bool = False):
    """The embedded tokens with the frontend applied -> (x, the encoder
    output or None, the number of prefix positions)."""
    x = _embed(params, tokens, cfg, ctx)
    if cfg.frontend == "none" or (cfg.frontend == "audio" and not cfg.n_enc_layers):
        return x, None, 0
    if frontend is None:
        raise ValueError(f"{cfg.name}: the {cfg.frontend} frontend needs its embeddings "
                         f"(frontend / batch['frontend'], (B, {cfg.n_frontend_tokens}, "
                         f"{cfg.d_model}))")
    if cfg.frontend == "vision":
        return torch.cat([frontend.to(x.dtype), x], dim=1), None, frontend.shape[1]
    if frontend.dtype != x.dtype:  # torch does not promote mixed matmuls as jnp does
        raise ValueError(f"{cfg.name}: frame embeddings in {frontend.dtype}, the model in "
                         f"{x.dtype}")
    return x, _encoder_fwd(params, frontend, cfg, kv_block, ctx, remat), 0


def _cross_at(params: Params, where: Where, enc_out: Optional[torch.Tensor]):
    """The ``cross`` argument of a layer: super-block ``s``'s cross-attention
    params with the encoder output, for the blocks' attention layers."""
    if enc_out is None or where.part != "blocks" or where.kind != "attn":
        return None
    return enc_out, _stacked_at(params["cross_blocks"], where.s)


def _hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            frontend: Optional[torch.Tensor], kv_block: int,
            block_provider: Optional[Callable[[Params], Params]], ctx: ShardCtx,
            remat: bool = False):
    """The final-normed hidden states of the text positions and the aux
    loss.  Each super-block of ``blocks`` (its ``block_provider`` call
    included) is one checkpointed function under ``remat``.  Under
    ``ctx.seq_parallel`` the blocks run on a rank's rows of the residual
    where :func:`~repro_torch.models.sharding.seq_ok` allows the split
    (the residual cut after the embedding, gathered after the last
    block); everything else runs on the whole residual."""
    whole = ctx.whole()
    x, enc_out, n_prefix = _frontend_in(params, tokens, cfg, frontend, kv_block, whole, remat)
    if not cfg.cross_attention:
        enc_out = None
    n = x.shape[1]
    positions = torch.arange(n, device=x.device)[None, :]
    [(pattern, n_super)], tail = layer_groups(cfg)
    sp = ctx.seq_parallel and seq_ok(n, ctx.model)
    bctx = (dataclasses.replace(ctx, seq_parallel=sp, seq_len=n) if seq_ok(n, ctx.model)
            else whole)
    if sp:
        x = ctx.axes.model_cut(x, 1)

    @trace.spanned("block")  # inside the checkpointed function: its recompute is spanned too
    def block(s: int, x: torch.Tensor, aux: torch.Tensor):
        leaves = {k: _stacked_at(g, s) for k, g in params["blocks"].items()}
        if block_provider is not None:
            leaves = block_provider(leaves)
        for i, kind in enumerate(pattern):
            where = Where("blocks", f"p{i}_{kind}", s, kind)
            x, a, _ = _layer_fwd(where, leaves[where.key], x, cfg, positions, kv_block,
                                 _cross_at(params, where, enc_out), bctx)
            aux = aux + a
        return x, aux

    aux = _zero(x)
    for s in range(n_super):
        x, aux = _remat(lambda x, aux, s=s: block(s, x, aux), remat, x, aux)
    if sp:
        x = ctx.axes.model_full(x, 1, n)
    for j, kind in enumerate(tail):
        x, a, _ = _layer_fwd(Where("tail", j, None, kind), params["tail"][j], x, cfg, positions,
                             kv_block, None, whole)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, n_prefix:], aux


def _head_parts(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx):
    """The lm head's context and per-rank logits (B, S, V/M) with V split
    (or the whole logits with nothing split)."""
    c = _on(ctx, ctx.modes(cfg).lm_head is not None)
    xe = c.enter(x)
    return c, [c.local(xe, k) @ c.shard(w, 1, k) for k in c.ranks()]


def _logits(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx) -> torch.Tensor:
    if ctx.modes(cfg).lm_head == 0:  # D split: partial logits summed
        return _row_parallel(x, w, True, ctx)
    c, parts = _head_parts(x, w, cfg, ctx)
    return c.cat(parts, -1)


def _vocab_parallel_ce(parts, labels: torch.Tensor, mask, vl: int, ctx: ShardCtx):
    """Token-level mean cross entropy over logits split on V: the max
    logit pmaxed (no gradient), the exponential sums and the target's
    logit psummed (one non-zero term per target)."""
    parts = [p.float() for p in parts]
    mx = ctx.pmax([p.detach().amax(dim=-1) for p in parts])
    se, gold = [], []
    lab = labels.long()
    for k, p in zip(ctx.ranks(), parts):
        se.append(torch.exp(p - mx[..., None]).sum(dim=-1))
        t = lab - k * vl
        ok = (t >= 0) & (t < vl)
        g = torch.gather(p, -1, torch.where(ok, t, torch.zeros_like(t))[..., None])[..., 0]
        gold.append(torch.where(ok, g, torch.zeros_like(g)))
    nll = torch.log(ctx.reduce(se)) + mx - ctx.reduce(gold)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            frontend: Optional[torch.Tensor] = None, kv_block: int = 1024,
            block_provider: Optional[Callable[[Params], Params]] = None,
            ctx: ShardCtx = NULL_CTX, remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: tokens (B, S) -> (logits (B, S, V), aux loss);
    a vision prefix is stripped before the lm head.  Under a model axis
    the logits are whole on every rank.

    ``block_provider`` (FSDP, :mod:`repro_torch.launch.steps`) maps one
    super-block of the ``blocks`` group, ``{key: {name: layer leaf}}``, to
    the leaves its layers run with (the gathered weights), once a
    super-block, as the reference applies it inside its layer scan.
    ``remat`` checkpoints each super-block and each encoder layer (module
    docstring); it changes no bit of the result."""
    x, aux = _hidden(params, tokens, cfg, frontend, kv_block, block_provider, ctx, remat)
    return _logits(x, params["lm_head"], cfg, ctx.whole()), aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            kv_block: int = 1024, aux_weight: float = 0.01,
            block_provider: Optional[Callable[[Params], Params]] = None,
            ctx: ShardCtx = NULL_CTX, remat: bool = True) -> torch.Tensor:
    """Mean cross entropy plus ``aux_weight`` times the MoE aux loss; with
    the lm head split on V, a vocab-parallel cross entropy (no rank holds
    the whole logits).  ``remat`` as in :func:`forward`."""
    x, aux = _hidden(params, batch["tokens"], cfg, batch.get("frontend"), kv_block,
                     block_provider, ctx, remat)
    ctx = ctx.whole()
    if ctx.modes(cfg).lm_head == 1:
        _, parts = _head_parts(x, params["lm_head"], cfg, ctx)
        ce = _vocab_parallel_ce(parts, batch["labels"], batch.get("mask"),
                                cfg.vocab // ctx.model, ctx)
    else:
        ce = L.cross_entropy(_logits(x, params["lm_head"], cfg, ctx), batch["labels"],
                             batch.get("mask"))
    return ce + aux_weight * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_window(cfg: ModelConfig, cache_len: int) -> int:
    """Slots of an attention layer's cache: ``cache_len``, capped by the
    hybrid pattern's local window, else the sliding window (native or the
    long-context variant) — a ring buffer."""
    cap = cfg.local_window if cfg.hybrid_pattern else (
        cfg.sliding_window or cfg.long_context_window)
    return min(cache_len, cap) if cap else cache_len


def decode_window(cfg: ModelConfig) -> int:
    """The window a decode step attends over (0 = the whole cache)."""
    if cfg.hybrid_pattern:
        return cfg.local_window
    return cfg.sliding_window or cfg.long_context_window or 0


def _stack_layers(cfg: ModelConfig, per_layer: List[Params]) -> Params:
    """A cache tree from one dict per layer (:func:`layer_slots` order):
    block entries stacked over the super-blocks, the tail a list."""
    blocks: Dict[str, List[Params]] = {}
    tail = []
    for where, c in zip(layer_slots(cfg), per_layer):
        if where.part == "tail":
            tail.append(c)
        else:
            blocks.setdefault(where.key, []).append(c)
    cache: Params = {"blocks": {key: {leaf: torch.stack([c[leaf] for c in cs])
                                      for leaf in sorted(cs[0])}
                                for key, cs in sorted(blocks.items())}}
    if tail:
        cache["tail"] = tail
    return cache


def _empty_layer_cache(kind: str, cfg: ModelConfig, b: int, eff: int,
                       dev: torch.device) -> Params:
    dtype = _dt(cfg)
    if kind == "attn":
        shape = (b, eff, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "kpos": torch.full((eff,), -1, dtype=torch.int32, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if kind == "ssm":
        s, _, nheads, conv_dim = _ssm_dims(cfg)
        return {"conv": torch.zeros((b, s.conv_width - 1, conv_dim), dtype=dtype, device=dev),
                "ssd": torch.zeros((b, nheads, s.head_dim, s.d_state), dtype=torch.float32,
                                   device=dev)}
    return {"conv": torch.zeros((b, 3, cfg.d_model), dtype=dtype, device=dev),
            "h": torch.zeros((b, cfg.d_model), dtype=torch.float32, device=dev)}


def init_cache(cfg: ModelConfig, b: int, cache_len: int, device="cuda") -> Params:
    """Empty cache, the reference's tree: attention k/v (.., b, eff, KV, hd)
    and kpos (.., eff) = -1 (every slot masked); SSM conv window and f32
    state; RG-LRU conv window and f32 state; block leaves led by n_super;
    with cross-attention, ``cross`` k/v (n_super, b, n_frontend_tokens, KV,
    hd)."""
    dev = resolve(device)
    eff = cache_window(cfg, cache_len)
    cache = _stack_layers(cfg, [_empty_layer_cache(w.kind, cfg, b, eff, dev)
                                for w in layer_slots(cfg)])
    if cfg.cross_attention and cfg.n_enc_layers:
        [(_, n_super)], _ = layer_groups(cfg)
        shape = (n_super, b, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.hd)
        cache["cross"] = {k: torch.zeros(shape, dtype=_dt(cfg), device=dev) for k in "kv"}
    return dict(sorted(cache.items()))


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


def _cross_cache(cp: Params, enc_out: torch.Tensor, cfg: ModelConfig,
                 ctx: ShardCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's cross keys and values for the cache: in the cross
    layers' ``heads`` and ``padded`` modes each model rank projects its kv
    heads (:func:`_on_heads`), which are concatenated in rank order (in
    process every rank's: the whole heads; under a process group the rank's
    own); in ``gathered`` mode ``wk`` / ``wv`` are gathered and the cache is
    whole."""
    ecfg = _enc_cfg(cfg)
    cp = _gathered(cp, ecfg, ctx, ("wk", "wv"))  # the keys' and values' projections only
    c = _attn_ctx(ctx, ecfg)
    ks, vs = zip(*((_kv_split(k, cfg.hd), _kv_split(v, cfg.hd))
                   for k, v in _on_heads(c, ecfg, enc_out, cp, ("wk", "wv"))))
    return (torch.cat(ks, 2), torch.cat(vs, 2)) if len(ks) > 1 else (ks[0], vs[0])


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            frontend: Optional[torch.Tensor] = None, kv_block: int = 1024,
            cache_len: Optional[int] = None,
            ctx: ShardCtx = NULL_CTX) -> Tuple[torch.Tensor, Params]:
    """Full forward that also builds the serving cache, attention caches
    sized ``cache_len`` (prompt + generation budget; default the prompt):
    returns the last token's logits (B, 1, V) and the cache.

    Under a model axis (``ctx``) the layers run as in :func:`forward`; in
    ``heads`` and ``padded`` modes each rank's cache holds its own kv heads
    (in process the ranks' heads side by side: the whole cache; zero wide
    on a rank past the last kv head), ``kpos`` whole; the
    ``ssm`` state its heads and the ``rec`` states its channels (the
    layout :func:`~repro_torch.models.sharding.cache_dims` names); the
    logits are whole on every rank (:func:`_logits`).

    Audio: the encoder runs once and each super-block's cross keys and
    values go to ``cache["cross"]`` (under a model axis in the cross layers'
    attention mode: in ``heads`` and ``padded`` each rank's kv heads, as the
    self caches).
    Vision: as in the reference, the patch prefix stays in the attention
    caches while their ``kpos`` is sized by the text alone, a cache
    :func:`decode_step` refuses."""
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    ctx = ctx.whole()  # serving never splits the sequence, as the reference's _serve_ctx
    eff = cache_window(cfg, cache_len)
    x, enc_out, _ = _frontend_in(params, tokens, cfg, frontend, kv_block, ctx)
    if not cfg.cross_attention:
        enc_out = None
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    per_layer, cross = [], []
    for where in layer_slots(cfg):
        cx = _cross_at(params, where, enc_out)
        x, _, state = _layer_fwd(where, layer_at(params, where), x, cfg, positions, kv_block,
                                 cx, ctx)
        per_layer.append(_fill_attn_cache(*state, eff, s) if where.kind == "attn" else state)
        if cx is not None:
            cross.append(_cross_cache(cx[1], enc_out, cfg, ctx))
    cache = _stack_layers(cfg, per_layer)
    if cross:
        cache["cross"] = {"k": torch.stack([k for k, _ in cross]),
                          "v": torch.stack([v for _, v in cross])}
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x[:, -1:], params["lm_head"], cfg, ctx), dict(sorted(cache.items()))


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
                 pos: torch.Tensor, window: int, cross=None,
                 ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """One-token attention layer step; writes the new key/value and its
    position into the layer cache ``lc`` in place (slot = pos % eff).
    ``cross``: (this block's cross k/v cache, its cross-attention params)
    or None.  Under ``ctx``'s ``heads`` and ``padded`` modes each model
    rank projects its kv heads (:func:`_on_heads`), writes them into its
    heads of the cache (in process a slice of the whole cache, under a
    process group the rank's own cache, zero wide past the last kv head)
    and attends over them; ``wo`` is row-parallel (:func:`_wo_parts`), the
    partials psummed."""
    b = x.shape[0]
    eff = lc["k"].shape[1]
    if lc["kpos"].shape[-1] != eff:
        raise ValueError(
            f"{cfg.name}: the cache holds {eff} key rows a layer but {lc['kpos'].shape[-1]} "
            f"positions (kpos): the reference's vision prefill keeps the "
            f"{eff - lc['kpos'].shape[-1]}-row patch prefix in the cache and sizes kpos by "
            f"the text, and its decode_step cannot read such a cache (incompatible shapes), "
            f"so neither does this one")
    y = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    posv = pos.reshape(-1, 1)
    slot = pos % eff
    rows = torch.arange(b, device=x.device) if lc["kpos"].dim() == 2 else None
    if rows is None:  # one position for the whole batch (an index tensor: no host read)
        lc["kpos"].index_fill_(0, slot.reshape(1), pos.to(torch.int32))
    else:  # a position per row (the slot pool)
        lc["kpos"][rows, slot] = pos.to(torch.int32)
    p = _gathered(p, cfg, ctx)
    c = _attn_ctx(ctx, cfg)
    ranks = c.ranks()
    outs = []
    for r, (q, k, v) in zip(ranks, _on_heads(c, cfg, c.enter(y), p, _QKV)):
        q, k, v = _to_heads(q, k, v, cfg, posv, p)
        kc, vc = lc["k"], lc["v"]
        if len(ranks) > 1:  # rank r's heads of the whole cache
            h0, h1 = kv_heads(cfg.n_kv_heads, c.model, r)
            kc, vc = kc.narrow(2, h0, h1 - h0), vc.narrow(2, h0, h1 - h0)
        if rows is None:
            kc.index_copy_(1, slot.reshape(1), k)
            vc.index_copy_(1, slot.reshape(1), v)
        else:
            kc[rows, slot] = k[:, 0]
            vc[rows, slot] = v[:, 0]
        outs.append(_flat_heads(_cache_attention(q, kc.contiguous(), vc.contiguous(),
                                                 lc["kpos"], pos, window)))
    x = x + c.reduce(_wo_parts(c, cfg, outs, p["wo"]))
    if cross is not None:
        x = x + _cross_decode(cross, x, cfg, ctx)
    return _ffn(p, x, cfg, ctx)[0]


def _cross_decode(cross, x: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx) -> torch.Tensor:
    """One decode step's cross-attention output (B, 1, D) over the cached
    encoder keys and values (every slot valid: kpos 0..t-1, pos 2^30);
    ``cross`` is (this block's cross cache, its cross-attention params).
    In the cross layers' ``heads`` and ``padded`` modes each model rank
    attends with its heads over its kv heads of the cache
    (:func:`_cross_cache`'s layout) and ``wo`` is row-parallel, the
    partials summed in rank order, as :func:`_cross_attention` in
    training; in ``gathered`` mode ``wq`` / ``wo`` are gathered whole."""
    ck, cp = cross
    ecfg = _enc_cfg(cfg)
    cp = _gathered(cp, ecfg, ctx, ("wq", "wo"))  # the keys and values are cached
    c = _attn_ctx(ctx, ecfg)
    t = ck["k"].shape[1]
    ye = c.enter(L.rms_norm(x, cp["ln1"], cfg.norm_eps))
    kpos = torch.arange(t, dtype=torch.int32, device=x.device)
    pos = torch.full((), 2 ** 30, dtype=torch.int64, device=x.device)
    ranks = c.ranks()
    outs = []
    for r, (q,) in zip(ranks, _on_heads(c, ecfg, ye, cp, ("wq",))):
        kc, vc = ck["k"], ck["v"]
        if len(ranks) > 1:  # rank r's heads of the whole cache
            h0, h1 = kv_heads(cfg.n_kv_heads, c.model, r)
            kc, vc = kc.narrow(2, h0, h1 - h0), vc.narrow(2, h0, h1 - h0)
        q = q.reshape(q.shape[:-1] + (kc.shape[2], cfg.n_heads // cfg.n_kv_heads, cfg.hd))
        outs.append(_flat_heads(_cache_attention(q, kc, vc, kpos, pos, 0)))
    return c.reduce(_wo_parts(c, ecfg, outs, cp["wo"]))


def _ssm_decode(p: Params, x: torch.Tensor, lc: Params, cfg: ModelConfig,
                ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """One-token SSM step; updates the layer cache's conv window and state
    in place.  Under a model axis as :func:`_ssm_layer_fwd`: in ``heads``
    mode the rank's heads of the state, in ``gathered`` mode the whole."""
    if ctx.modes(cfg).ssm == "heads":
        return _ssm_heads(p, x, cfg, ctx, lc)[0]
    p = _gather_in(p, cfg, ctx)
    z, xdt, xh, loga, bm, cm, conv_state = _ssm_in(p, x, cfg, lc["conv"])
    yh, state = ssm_lib.ssd_decode_step(lc["ssd"], xdt[:, 0], loga[:, 0], bm[:, 0], cm[:, 0])
    lc["conv"].copy_(conv_state)
    lc["ssd"].copy_(state)
    return _ssm_out(p, x, yh[:, None], xh, z, cfg, ctx)


def _rec_decode(p: Params, x: torch.Tensor, lc: Params, cfg: ModelConfig,
                ctx: ShardCtx = NULL_CTX) -> torch.Tensor:
    """One-token recurrent step; updates the layer cache in place (under a
    model axis the rank's channels, as :func:`_rec_layer_fwd`)."""
    return _rec_mixer(p, x, cfg, ctx, lc)[0]


def decode_step(params: Params, token: torch.Tensor, cache: Params, pos,
                cfg: ModelConfig, ctx: ShardCtx = NULL_CTX) -> Tuple[torch.Tensor, Params]:
    """One decode step: token (B, 1) at absolute position ``pos`` (a scalar,
    or (B,) positions for a cache whose kpos has a row per batch row).

    Returns (logits (B, 1, V), cache); the cache is updated IN PLACE (the
    reference donates it to the same effect).  A cache whose attention
    keys and positions differ in length (a vision prefill's) raises, as
    the reference's decode does.  Under a model axis (``ctx``) the cache
    is :func:`prefill`'s layout and the logits are whole on every rank."""
    x = _embed(params, token, cfg, ctx)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    window = decode_window(cfg)
    has_cross = cfg.cross_attention and "cross" in cache
    for where in layer_slots(cfg):
        p, lc = layer_at(params, where), layer_at(cache, where)
        if where.kind == "attn":
            cross = None
            if has_cross and where.part == "blocks":
                cross = (_stacked_at(cache["cross"], where.s),
                         _stacked_at(params["cross_blocks"], where.s))
            x = _attn_decode(p, x, lc, cfg, pos, window, cross, ctx)
        elif where.kind == "ssm":
            x = _ssm_decode(p, x, lc, cfg, ctx)
        else:
            x = _rec_decode(p, x, lc, cfg, ctx)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params["lm_head"], cfg, ctx), cache
