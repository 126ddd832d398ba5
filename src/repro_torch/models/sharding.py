"""Partition rules for parameter leaves and the model-axis context (the
reference's ``repro.models.sharding``).

A spec is a tuple with one entry per dim: an axis name (or a tuple of
them) where the dim is split over that mesh axis, ``None`` where it is
whole; the reference's ``PartitionSpec`` as a plain tuple.  The rules
are pure functions of a leaf's path and shape, so they need no mesh.

The model-parallel ("megatron") rules mark one dim of each weight with
the ``model`` axis.  At model size 1 every leaf with a rule gets ``model``
on its first preferred dim (every size divides by 1), which the FSDP dims
(:func:`repro_torch.launch.steps.fsdp_dims`) read to stay off it, as the
reference's do.  At model size M > 1 the split is real: tensor
parallelism.  The reference leaves the layout to GSPMD (its ``ShardCtx``
constrains activations, it does not change the function); the port
computes each layer on the shards explicitly, through :class:`ShardCtx`:

- ``heads``: q/k/v are column-parallel on the local heads and ``wo`` is
  row-parallel, when the split falls on whole kv heads (``kv % M == 0``);
- ``gathered``: where the rule cuts through a head or through ``hd``
  (RoPE pairs ``i`` with ``i + hd/2``, so half a head cannot be rotated
  alone), the split attention leaves are all-gathered over ``model`` for
  the compute and each rank keeps its chunk of the whole gradient; the
  MoE router is always gathered (its product is small), so routing is
  the global top-k;
- the dense FFN is column-parallel on F (``wg``/``wu``) and row-parallel
  (``wd``); the MoE experts are expert-parallel where E divides by M, else
  split on F, as the rule falls back;
- the ``ssm`` (Mamba-2 SSD) and ``rec`` (RG-LRU) mixers read every
  channel of their in-projections: the SSM's ``w_in`` packs z | x | B | C
  | dt, so a contiguous chunk cuts across the pieces, and the RG-LRU's
  square gates ``w_a`` / ``w_xg`` mix all channels.  Those split leaves
  (with the branch projections ``w_bx`` / ``w_bg``) are gathered; the
  conv, the SSD or the scan and the gate product run whole on every
  rank, and the out-projections ``w_out`` / ``w_ro`` are row-parallel (a
  rank's chunk of the mixer output times its rows, the partials psummed).
  The per-channel leaves are replicated.  ``rec``'s GeGLU splits on F as
  the dense FFN;
- the whisper encoder's layers and the cross-attention take the attention
  mode of the encoder config (no MoE, no qk-norm) and its F-split FFN;
  the vision prefix is concatenated to the whole embedding and needs no
  split;
- the embedding is vocab-parallel (masked lookups, psummed: one non-zero
  term per element) where its rule takes V, else each rank looks up its
  d_model columns and they are all-gathered; the lm head with V split
  feeds a vocab-parallel cross-entropy, with D split its partial logits
  are psummed.

:func:`tp_plan` lists, leaf by leaf, the split dim and whether the layer
computes on the shard (``shard``) or on the gathered whole
(``gathered``), for every configuration.

Sequence parallelism (:class:`ShardCtx`'s ``seq_parallel``, the train
step's flag) splits the residual between the layers of a super-block
over ``model`` along S, where :func:`seq_ok` allows it.

Serving caches follow the attention layers: in ``heads`` mode each rank's
attention keys and values are its own kv heads (:func:`cache_dims`,
:func:`shard_cache`), the positions (``kpos``) whole on every rank; in
``gathered`` mode the caches stay whole on every rank, as do the ``ssm``
/ ``rec`` states.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.tree import (tree_leaves_with_path, tree_map, tree_map_with_path,
                              tree_unflatten_like)

Spec = Tuple[Optional[str], ...]

# candidate dims in preference order; the first one divisible by the
# model-axis size wins (grok's 8 experts cannot split 16 ways, so its
# expert FFNs fall back to F)
RULES = {
    "embed": [0, 1],  # (V, D) -> vocab, else d_model
    "lm_head": [1, 0],  # (D, V)
    "wq": [-1], "wk": [-1], "wv": [-1],  # (.., D, H*hd) -> head product
    "wo": [-2],  # (.., H*hd, D)
    "wg": [-1], "wu": [-1],  # (.., D, F)
    "wd": [-2],  # (.., F, D)
    "we_g": [-3, -1], "we_u": [-3, -1],  # (.., E, D, F) -> experts, else F
    "we_d": [-3, -2],  # (.., E, F, D)
    "router": [-1, -2],  # (.., D, E)
    "w_in": [-1],  # ssm in-proj packed
    "w_out": [-2],
    "w_bx": [-1], "w_bg": [-1],  # rec branch projections (.., D, C)
    "w_ro": [-2],  # rec out  (.., C, D)
    "w_a": [-1], "w_xg": [-1],  # rglru square mats
}


def param_partition_spec(path: str, shape: Tuple[int, ...], model_axis: str = "model",
                         mesh_model: int = 16) -> Spec:
    """The model-axis spec of the leaf at ``path`` (keys joined by ``/``;
    the rule is keyed on the last one): the first preferred dim whose
    size is at least ``mesh_model`` and divisible by it, else replicated."""
    spec = [None] * len(shape)
    for dim in RULES.get(path.split("/")[-1], []):
        d = dim % len(shape)
        if shape[d] % mesh_model == 0 and shape[d] >= mesh_model:
            spec[d] = model_axis
            break
    return tuple(spec)


def tree_partition_specs(params, model_axis: str = "model", mesh_model: int = 16):
    """A spec for every leaf of ``params`` (tensors, meta tensors included)."""
    return tree_map_with_path(
        lambda path, leaf: param_partition_spec(path, tuple(leaf.shape), model_axis,
                                                mesh_model), params)


def split_dim(path: str, shape: Tuple[int, ...], model: int) -> int:
    """The dim the model axis splits at size ``model`` (-1: none).  At
    model size 1 nothing is split."""
    if model == 1:
        return -1
    spec = param_partition_spec(path, shape, "model", model)
    return next((d for d, e in enumerate(spec) if e == "model"), -1)


# ---------------------------------------------------------------------------
# the layers' tensor-parallel modes
# ---------------------------------------------------------------------------


class TPModes(NamedTuple):
    """How a configuration's layers compute at one model size.

    ``attn``: None (nothing split), ``"heads"`` or ``"gathered"``, and
    ``attn_split`` the attention leaves the rules split; ``ffn``: the
    dense FFN (and ``rec``'s GeGLU) split on F; ``moe``: None,
    ``"experts"`` or ``"hidden"``; ``router``, ``embed`` and ``lm_head``:
    the split dim of the (unstacked) leaf, or None; ``mixer_in``: the
    ``ssm`` / ``rec`` in-projections the rules split (gathered for the
    compute), ``mixer_out``: their out-projections the rules split
    (row-parallel)."""

    attn: Optional[str]
    attn_split: Tuple[str, ...]
    ffn: bool
    moe: Optional[str]
    router: Optional[int]
    embed: Optional[int]
    lm_head: Optional[int]
    mixer_in: Tuple[str, ...] = ()
    mixer_out: Tuple[str, ...] = ()


_NO_TP = TPModes(None, (), False, None, None, None, None)


@functools.lru_cache(maxsize=None)
def tp_modes(cfg, model: int) -> TPModes:
    """The layer modes of ``cfg`` at model size ``model`` (the rules on the
    unstacked leaf shapes)."""
    from repro_torch.models import transformer as T

    if model == 1:
        return _NO_TP
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def dim(name, shape):
        s = split_dim(name, shape, model)
        return None if s < 0 else s

    attn_split = tuple(n for n, s in (("wk", (d, kv * hd)), ("wo", (h * hd, d)),
                                      ("wq", (d, h * hd)), ("wv", (d, kv * hd)))
                       if dim(n, s) is not None)
    attn = None if not attn_split else ("heads" if kv % model == 0 else "gathered")
    moe = router = None
    ffn = False
    if cfg.moe is not None:
        e, fe = cfg.moe.num_experts, cfg.moe.d_expert
        we = dim("we_g", (e, d, fe))
        moe = None if we is None else ("experts" if we == 0 else "hidden")
        router = dim("router", (d, e))
    elif cfg.d_ff:
        ffn = dim("wg", (d, cfg.d_ff)) is not None
    mixer = {}
    for kind in sorted({cfg.layer_kind(i) for i in range(cfg.n_layers)} - {"attn"}):
        for name, spec in T._layer_specs(kind, cfg).items():
            if name in _MIXER_IN + _MIXER_OUT and dim(name, spec.shape) is not None:
                mixer[name] = True
    return TPModes(attn, attn_split, ffn, moe, router, dim("embed", (cfg.vocab, d)),
                   dim("lm_head", (d, cfg.vocab)),
                   tuple(n for n in sorted(mixer) if n in _MIXER_IN),
                   tuple(n for n in sorted(mixer) if n in _MIXER_OUT))


_ATTN = ("wq", "wk", "wv", "wo")
_MIXER_IN = ("w_a", "w_bg", "w_bx", "w_in", "w_xg")  # ssm / rec, gathered
_MIXER_OUT = ("w_out", "w_ro")  # ssm / rec, row-parallel


def tp_plan(cfg, model: int) -> Dict[str, Tuple[int, str]]:
    """``{leaf path: (split dim, mode)}`` for every leaf the model axis
    splits at size ``model`` (dims of the leaf as stored, the stacking dim
    included): ``shard`` where the layer computes on the rank's shard,
    ``gathered`` where the leaf is all-gathered for the compute (attention
    leaves in ``gathered`` mode, the MoE router, the ``ssm`` / ``rec``
    in-projections).  The encoder and cross-attention groups follow the
    encoder config's attention mode.  Replicated leaves are not listed."""
    from repro_torch.models import transformer as T

    modes = tp_modes(cfg, model)
    enc = tp_modes(T._enc_cfg(cfg), model)
    out = {}
    for path, leaf in tree_leaves_with_path(T.meta_params(cfg)):
        d = split_dim(path, tuple(leaf.shape), model)
        if d < 0:
            continue
        group, name = path.split("/")[0], path.split("/")[-1]
        attn = (enc if group in ("enc_blocks", "cross_blocks") else modes).attn
        gathered = ((name in _ATTN and attn == "gathered") or name == "router"
                    or name in _MIXER_IN)
        out[path] = (d, "gathered" if gathered else "shard")
    return out


def cache_dims(cfg, model: int, cache, specs):
    """The split dim of every leaf of the serving ``cache`` at model size
    ``model`` (-1: whole), read from
    :func:`repro_torch.launch.steps.cache_shardings`' ``specs`` (a spec
    tuple per leaf): the serving counterpart of :func:`tp_dims`, in a
    tree shaped like ``cache`` (whose leaves may be meta tensors).

    Only the attention keys and values of ``heads`` mode are split, on their
    kv-head dim: the self-attention caches in the layers' mode, the cross
    caches (``cross/k``, ``cross/v``) in the cross layers' (the encoder
    config's, :func:`tp_plan`).  In ``gathered`` mode (kv heads not
    divisible by ``model``, e.g. one kv head) the reference's spec falls to
    the head dim ``hd``: a GSPMD layout of the same function, which the port
    does not compute split (the layer computes from gathered leaves), so the
    caches stay whole on every rank.  The ``ssm`` / ``rec`` states
    (``conv``, ``ssd``, ``h``) stay whole for the same reason: the
    reference's specs split ``ssd`` on its heads and ``conv`` / ``h`` on
    channels, but the port's mixer runs whole on every rank from the
    gathered in-projections, so every rank updates the whole state alike.
    The worker-axis entries (the batch) are not read here."""
    from repro_torch.models import transformer as T

    heads = tp_modes(cfg, model).attn == "heads"
    cross_heads = tp_modes(T._enc_cfg(cfg), model).attn == "heads"
    spec_of = []
    tree_map(lambda _, spec: spec_of.append(spec), cache, specs)

    def dim(path, spec):
        if not (cross_heads if path.startswith("cross") else heads) \
                or path.split("/")[-1] not in ("k", "v"):
            return -1
        d = next((i for i, e in enumerate(spec) if e == "model"), -1)
        return d if d == len(spec) - 2 else -1

    return tree_unflatten_like(cache, [dim(path, spec) for (path, _), spec
                                       in zip(tree_leaves_with_path(cache), spec_of)])


def shard_cache(cache, dims, k: int, model: int):
    """Model rank ``k``'s slice of a whole cache tree: chunk ``k`` along each
    leaf's dim of ``dims`` (:func:`cache_dims`), copied; a leaf with dim -1
    as it is.  At model size 1 the tree itself."""
    if model == 1:
        return cache

    def cut(t, d):
        return t if d < 0 else t.chunk(model, d)[k].clone(memory_format=torch.contiguous_format)

    return tree_map(cut, cache, dims)


def tp_dims(cfg, model: int):
    """The split dim of every parameter leaf (-1: replicated), in a tree
    shaped like the params."""
    from repro_torch.models import transformer as T

    return tree_map_with_path(lambda path, leaf: split_dim(path, tuple(leaf.shape), model),
                              T.meta_params(cfg))


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------


def shard_ok(d: int, axes: Tuple[str, ...], mesh_shape: dict) -> bool:
    """The reference's ``ShardCtx._ok`` rule: shard a dim of size d over
    ``axes`` if divisible, or unevenly (GSPMD pads) when at least half the
    shards are non-empty (e.g. kv=8 heads over model=16 -> shard size 1, 8
    padding shards: acceptable; kv=1 MQA stays replicated)."""
    size = math.prod(mesh_shape.get(a, 1) for a in axes)
    return bool(axes) and (d % size == 0 or 2 * d >= size)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The model axis a forward runs over: its size and the mesh's
    :class:`~repro_torch.core.distributed.Collectives`, whose ``model_*``
    calls the layers use.  At model size 1 (:data:`NULL_CTX`) every
    operation is the identity, so a layer computes exactly what it
    computes on the whole leaf.

    ``seq_parallel`` (sequence parallelism, Korthikanti et al.; the
    reference's flag): between the layers of a super-block the residual
    stream is split over the model axis along S (``seq_len`` long), where
    :func:`seq_ok` allows it, and the layers' norms run on a rank's rows.
    At each model-axis boundary Megatron-SP's conjugate pair replaces
    Megatron-TP's: :meth:`sp_enter` gathers the rows (its backward a
    reduce-scatter) where TP enters, :meth:`sp_reduce` reduce-scatters the
    partial outputs (its backward an all-gather) where TP sums them; a
    layer that computes whole on every rank gathers the rows and keeps its
    own of the output.  The train step sets it (the transformer gives its
    blocks a context with it and the embedding, the encoder, the tail and
    the head one without); serving never does, as the reference's
    ``_serve_ctx``."""

    model: int = 1
    axes: Any = None  # the mesh's Collectives
    seq_parallel: bool = False
    seq_len: int = 0  # S of the blocks' residual where seq_ok splits it (0 elsewhere)

    def modes(self, cfg) -> TPModes:
        return tp_modes(cfg, self.model)

    # -- the model-axis operations (identity at model size 1)

    def ranks(self) -> Sequence[int]:
        return (0,) if self.model == 1 else self.axes.model_ranks()

    def shard(self, w, dim: int, k: int):
        return w if self.model == 1 else self.axes.model_shard(w, dim, k)

    def split(self, x, dim: int, k: int):
        return x if self.model == 1 else self.axes.model_split(x, dim, k)

    def enter(self, x):
        return x if self.model == 1 else self.axes.model_enter(x)

    def local(self, x):
        return x if self.model == 1 else self.axes.model_local(x)

    def reduce(self, parts):
        return parts[0] if self.model == 1 else self.axes.model_sum(parts)

    def cat(self, parts, dim: int):
        return parts[0] if self.model == 1 else self.axes.model_cat(parts, dim)

    def full(self, w, dim: int):
        return w if self.model == 1 else self.axes.model_full(w, dim)

    def pmax(self, parts):
        return parts[0] if self.model == 1 else self.axes.model_max(parts)

    # -- sequence parallelism: ``c`` is the context a layer computes under
    # (this one where the layer splits over the model axis, else NULL_CTX)

    def sp_enter(self, c: "ShardCtx", y):
        """The whole activation a layer reads of the rank's normed rows
        ``y`` (without sequence parallelism ``c.enter(y)``): Megatron-SP's
        all-gather where the layer splits over the model axis, else the
        rows gathered for a computation every rank runs alike."""
        if not self.seq_parallel:
            return c.enter(y)
        if c.model > 1:
            return self.axes.seq_enter(y, 1, self.seq_len)
        return self.axes.model_full(y, 1, self.seq_len)

    def sp_reduce(self, c: "ShardCtx", parts):
        """The rank's rows of a layer's output (without sequence parallelism
        ``c.reduce(parts)``): Megatron-SP's reduce-scatter of the ranks'
        partials, or the rank's rows of an output every rank computed
        alike."""
        if not self.seq_parallel:
            return c.reduce(parts)
        if c.model > 1:
            return self.axes.seq_reduce(parts, 1, self.seq_len)
        return self.axes.model_cut(parts[0], 1)

    def whole(self) -> "ShardCtx":
        """This context outside the super-blocks: no sequence parallelism,
        no block residual length."""
        return dataclasses.replace(self, seq_parallel=False, seq_len=0) \
            if self.seq_parallel or self.seq_len else self


NULL_CTX = ShardCtx()


def seq_ok(s: int, model: int) -> bool:
    """Whether a residual of S = ``s`` splits over ``model`` ranks: the
    reference's ``_ok`` rule (even, or uneven when at least half the
    shards are non-empty); otherwise it stays whole."""
    return model > 1 and shard_ok(s, ("model",), {"model": model})


def model_ctx(mesh, seq_parallel: bool = False) -> ShardCtx:
    """The context of a train step on ``mesh``: its model axis when larger
    than 1, else :data:`NULL_CTX` (constraints over a size-1 axis are
    no-ops, as in the reference's ``make_step_body``, sequence
    parallelism's included); ``seq_parallel`` as the step's
    ``ParallelConfig``."""
    shape = dict(zip(mesh.axis_names, mesh.shape))
    if shape.get("model", 1) == 1:
        return NULL_CTX
    return ShardCtx(shape["model"], mesh.axes, seq_parallel)
