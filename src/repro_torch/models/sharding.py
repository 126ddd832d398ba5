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
- ``padded``: where the kv heads do not divide ``M`` but the reference's
  ``_ok`` still splits them unevenly (``2·kv >= M``: GSPMD pads), rank
  ``r`` attends with the kv heads of :func:`kv_heads` (ceil(kv / M) a rank,
  the last ranks fewer or none) and their query groups.  The leaves keep
  their even chunks, which cut through heads: one all-to-all over
  ``model`` hands every rank its heads' columns of ``wq``/``wk``/``wv``
  and a second its heads' rows of ``wo`` (row-parallel, the partials
  summed in rank order); where the tokens are fewer than d_model (decode)
  the products by the chunks travel instead, and ``wo`` reads the output's
  columns of its even chunk;
- ``gathered``: where the reference replicates the kv heads too
  (``2·kv < M``, e.g. one kv head over 4 ranks), the split attention
  leaves are all-gathered over ``model`` for the compute and each rank
  keeps its chunk of the whole gradient (RoPE pairs ``i`` with ``i +
  hd/2``, so a rank cannot rotate the half head its chunk holds); the MoE
  router is always gathered (its product is small), so routing is the
  global top-k;
- the dense FFN is column-parallel on F (``wg``/``wu``) and row-parallel
  (``wd``); the MoE experts are expert-parallel where E divides by M, else
  split on F, as the rule falls back;
- the ``ssm`` (Mamba-2 SSD) mixer in ``heads`` mode (its heads divide by
  M, the reference's ``("b", None, "m", None)`` on the SSD's heads): each
  rank multiplies by its even chunk of the packed ``w_in`` (z | x | B | C
  | dt, so a chunk cuts across the pieces), and one all-to-all over
  ``model`` hands every rank its heads' z, x and dt columns and the B and
  C columns whole; the conv runs on the rank's x channels and B, C, the
  SSD and the gate on its heads, ``out_norm``'s mean square is the ranks'
  partial sums summed, and ``w_out`` is row-parallel.  Where the heads do
  not divide (``gathered``) the split ``w_in`` is gathered and the mixer
  runs whole on every rank before the row-parallel ``w_out``, as where
  ``w_in`` does not split at all;
- the ``rec`` (RG-LRU) mixer in ``channels`` mode (the reference's
  ``("b", None, "m")`` on its output): ``w_bx`` / ``w_bg`` are
  column-parallel on the rank's channels and so is the conv; the square
  gates ``w_a`` / ``w_xg`` read every channel of the conv output, which is
  all-gathered over ``model`` (its gradient reduce-scattered), and the
  rank's gate columns come from its chunks; the scan, its state and the
  gate product are on the rank's channels and ``w_ro`` is row-parallel.
  The per-channel leaves (``A_log``, ``dt_bias``, ``D_skip``,
  ``out_norm``, ``conv_w``, ``b_a``, ``b_x``, ``lam``) are replicated and a
  rank reads its heads' or channels' entries; ``rec``'s GeGLU splits on F
  as the dense FFN;
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

Serving caches follow the layers: in ``heads`` and ``padded`` modes each
rank's attention keys and values are its own kv heads (:func:`cache_dims`,
:func:`shard_cache`; a rank past the last kv head holds a zero-width
cache), the positions (``kpos``) whole on every rank; in ``gathered``
mode the caches stay whole on every rank.  The ``ssm``
state (``ssd``) is split on its heads and the ``rec`` conv window and
state (``conv``, ``h``) on channels, as the reference's specs split them;
the ``ssm`` conv window holds the rank's x channels and the B and C
channels whole (:class:`HeadsConv`).
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

    ``attn``: None (nothing split), ``"heads"`` (the kv heads divide by
    the model size), ``"padded"`` (they do not, and the reference's ``_ok``
    splits them unevenly: ``2·kv >= model``, the rules splitting all four
    leaves) or ``"gathered"`` (the leaves gathered whole), and
    ``attn_split`` the attention leaves the rules split; ``ffn``: the
    dense FFN (and ``rec``'s GeGLU) split on F; ``moe``: None,
    ``"experts"`` or ``"hidden"``; ``router``, ``embed`` and ``lm_head``:
    the split dim of the (unstacked) leaf, or None; ``mixer_in``: the
    ``ssm`` / ``rec`` in-projections the rules split, ``mixer_out``: their
    out-projections the rules split (row-parallel); ``ssm``: None (nothing
    split), ``"heads"`` (the SSD on each rank's heads: they divide by the
    model size and ``w_in`` splits) or ``"gathered"`` (the split ``w_in``
    gathered, the mixer whole); ``rec``: None or ``"channels"`` (the
    RG-LRU on each rank's channels; its rules split every projection or
    none)."""

    attn: Optional[str]
    attn_split: Tuple[str, ...]
    ffn: bool
    moe: Optional[str]
    router: Optional[int]
    embed: Optional[int]
    lm_head: Optional[int]
    mixer_in: Tuple[str, ...] = ()
    mixer_out: Tuple[str, ...] = ()
    ssm: Optional[str] = None
    rec: Optional[str] = None


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
    attn = None
    if attn_split:
        attn = ("heads" if kv % model == 0 else "padded"
                if len(attn_split) == 4 and shard_ok(kv, ("model",), {"model": model})
                else "gathered")
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
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    for kind in sorted(kinds - {"attn"}):
        for name, spec in T._layer_specs(kind, cfg).items():
            if name in _MIXER_IN + _MIXER_OUT and dim(name, spec.shape) is not None:
                mixer[name] = True
    ssm = rec = None
    if "ssm" in kinds and ("w_in" in mixer or "w_out" in mixer):
        ssm = "heads" if "w_in" in mixer and T._ssm_dims(cfg)[2] % model == 0 else "gathered"
    if "rec" in kinds and "w_bx" in mixer:
        rec = "channels"
    return TPModes(attn, attn_split, ffn, moe, router, dim("embed", (cfg.vocab, d)),
                   dim("lm_head", (d, cfg.vocab)),
                   tuple(n for n in sorted(mixer) if n in _MIXER_IN),
                   tuple(n for n in sorted(mixer) if n in _MIXER_OUT), ssm, rec)


_ATTN = ("wq", "wk", "wv", "wo")
HEAD_MODES = ("heads", "padded")  # the attention modes that split the kv heads


def kv_heads(kv: int, model: int, k: int) -> Tuple[int, int]:
    """Model rank ``k``'s kv heads ``[start, stop)`` in the attention's
    ``heads`` and ``padded`` modes: ceil(kv / model) a rank in order, as
    GSPMD pads an uneven split, so the last ranks hold fewer or none (kv 8
    over 16 ranks: one each on ranks 0-7, none on 8-15)."""
    c = -(-kv // model)
    return min(k * c, kv), min((k + 1) * c, kv)
_MIXER_IN = ("w_a", "w_bg", "w_bx", "w_in", "w_xg")  # ssm / rec in-projections
_MIXER_OUT = ("w_out", "w_ro")  # ssm / rec, row-parallel


def tp_plan(cfg, model: int) -> Dict[str, Tuple[int, str]]:
    """``{leaf path: (split dim, mode)}`` for every leaf the model axis
    splits at size ``model`` (dims of the leaf as stored, the stacking dim
    included): ``shard`` where the layer computes on the rank's shard (the
    attention leaves in ``heads`` and ``padded`` modes among them),
    ``gathered`` where the leaf is all-gathered for the compute (attention
    leaves in ``gathered`` mode, the MoE router, ``w_in`` in the ``ssm``
    mixer's ``gathered`` mode).  The encoder and cross-attention groups
    follow the encoder config's attention mode.  Replicated leaves are not
    listed."""
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
                    or (name == "w_in" and modes.ssm == "gathered"))
        out[path] = (d, "gathered" if gathered else "shard")
    return out


@dataclasses.dataclass(frozen=True)
class HeadsConv:
    """:func:`cache_dims`' entry for an ``ssm`` layer's conv window (.., B,
    W - 1, di + 2n) in the mixer's ``heads`` mode: along ``dim`` a rank
    holds its chunk of the first ``di`` channels (its heads' x) and the
    last ``2n`` (B and C) whole, di / model + 2n a row.  The reference
    splits the window evenly over its last dim, which does not follow the
    heads; the port keeps the channels a rank's conv reads instead, B and
    C's window on every rank (2n · (W - 1) values a row a layer more)."""

    dim: int
    di: int

    def cut(self, t: torch.Tensor, k: int, model: int) -> torch.Tensor:
        c = self.di // model
        return torch.cat([t.narrow(self.dim, k * c, c),
                          t.narrow(self.dim, self.di, t.shape[self.dim] - self.di)], self.dim)


def cache_dims(cfg, model: int, cache, specs):
    """The split dim of every leaf of the serving ``cache`` at model size
    ``model`` (-1: whole), read from
    :func:`repro_torch.launch.steps.cache_shardings`' ``specs`` (a spec
    tuple per leaf): the serving counterpart of :func:`tp_dims`, in a
    tree shaped like ``cache`` (whose leaves may be meta tensors).

    The attention keys and values of ``heads`` and ``padded`` modes are
    split on their kv-head dim, a rank's heads those of :func:`kv_heads`:
    the self-attention caches in the layers' mode, the cross caches
    (``cross/k``, ``cross/v``) in the cross layers' (the encoder config's,
    :func:`tp_plan`).  In ``padded`` mode the reference's spec, which
    splits only where the dim divides, falls to the head dim ``hd`` (a
    sixteenth of a row a rank at kv 8 over 16); the port keeps the heads
    its ranks attend with (an eighth on ranks 0-7, nothing on 8-15).  In
    ``gathered`` mode (``2·kv < model``, e.g. one kv head over 4) the
    reference's spec falls to ``hd`` too, a GSPMD layout the port does not
    compute split (the layer computes from gathered leaves), so the caches
    stay whole on every rank.  The recurrent states follow the
    mixers' modes: in the ``ssm`` mixer's ``heads`` mode ``ssd`` is split
    on its heads, as the reference's spec, and the conv window is a
    :class:`HeadsConv`; in the ``rec`` mixer's ``channels`` mode ``conv``
    and ``h`` are split on their channels, as the reference's specs; in
    ``gathered`` mode (and where nothing splits) they stay whole.  The
    worker-axis entries (the batch) are not read here."""
    from repro_torch.models import transformer as T

    modes = tp_modes(cfg, model)
    heads = modes.attn in HEAD_MODES
    cross_heads = tp_modes(T._enc_cfg(cfg), model).attn in HEAD_MODES
    kinds = {(f"blocks/{w.key}" if w.part == "blocks" else f"tail/{w.key}"): w.kind
             for w in T.layer_slots(cfg)}
    spec_of = []
    tree_map(lambda _, spec: spec_of.append(spec), cache, specs)

    def dim(path, spec):
        name, n = path.split("/")[-1], len(spec)
        split = next((i for i, e in enumerate(spec) if e == "model"), -1)
        kind = kinds.get(path.rsplit("/", 1)[0])
        if kind == "ssm" and modes.ssm == "heads":
            if name == "ssd":
                return split if split == n - 3 else -1
            return HeadsConv(n - 1, T._ssm_dims(cfg)[1]) if name == "conv" else -1
        if kind == "rec" and modes.rec == "channels":
            return split if name in ("conv", "h") and split == n - 1 else -1
        if not (cross_heads if path.startswith("cross") else heads) or name not in ("k", "v"):
            return -1
        return n - 2

    return tree_unflatten_like(cache, [dim(path, spec) for (path, _), spec
                                       in zip(tree_leaves_with_path(cache), spec_of)])


def padded_chunk(t: torch.Tensor, dim: int, k: int, model: int) -> torch.Tensor:
    """Chunk ``k`` of ``t`` along ``dim`` as GSPMD pads an uneven split:
    ceil(n / model) long, the last chunks shorter or empty (:func:`kv_heads`
    on the kv-head dim); an even split's chunk ``k``."""
    a, b = kv_heads(t.shape[dim], model, k)
    return t.narrow(dim, a, b - a)


def shard_cache(cache, dims, k: int, model: int):
    """Model rank ``k``'s slice of a whole cache tree: :func:`padded_chunk`
    ``k`` along each leaf's dim of ``dims`` (:func:`cache_dims`; a
    :class:`HeadsConv` its cut), copied; a leaf with dim -1 as it is.  At
    model size 1 the tree itself."""
    if model == 1:
        return cache

    def cut(t, d):
        if isinstance(d, HeadsConv):
            return d.cut(t, k, model).contiguous()
        return t if d < 0 else padded_chunk(t, d, k, model).clone(
            memory_format=torch.contiguous_format)

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

    def local(self, x, k: int):
        return x if self.model == 1 else self.axes.model_local(x, k)

    def reduce(self, parts):
        return parts[0] if self.model == 1 else self.axes.model_sum(parts)

    def cat(self, parts, dim: int):
        return parts[0] if self.model == 1 else self.axes.model_cat(parts, dim)

    def full(self, w, dim: int):
        return w if self.model == 1 else self.axes.model_full(w, dim)

    def gather(self, parts, dim: int):
        return parts[0] if self.model == 1 else self.axes.model_gather(parts, dim)

    def columns(self, parts, dim: int, wants):
        if self.model == 1:
            return [torch.cat([parts[0].narrow(dim, a, b - a) for a, b in wants[0]], dim)]
        return self.axes.model_columns(parts, dim, wants)

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
