"""Step builders (the reference's ``repro.launch.steps``).

Training: ``make_step_body`` / ``make_train_step`` — Algorithm 1 over a
worker axis.  Each worker computes its loss and gradient on its own batch
shard, the gradients meet through the configured robust strategy
(:func:`repro_torch.rounds.distributed.aggregate_by_strategy`), and every
worker applies the identical optimizer update.  On the debug mesh the m
workers live in one process (:mod:`repro_torch.launch.mesh`): worker by
worker, each gradient is written leaf by leaf into one worker-stacked
buffer (leaves (m, ...), allocated at the first step and reused) and
freed, so one worker's gradient is in flight at a time.  The reference
jits the step inside a ``shard_map``; here a step is eager torch whose
only host work is the launches: the step index, the attack and codec keys
and the Byzantine cut are host integers, and nothing reads the card.

Serving: prefill and decode steps, and the continuous-batching slot pool
under :mod:`repro_torch.serve.engine`.  The reference jits each step on a
mesh; here a step is a plain function on tensors on one device, run
eagerly.  Its pool is a vmap of batch-1 decodes over a leading slot axis,
because a batched cache shares one ``kpos`` across its rows.  The port
batches the slots directly instead: the pool's caches carry the slot axis
as their batch axis and a position per slot (``kpos`` (n_super, slots,
eff) in the blocks, (slots, eff) in the tail), and one tick is ONE
batched decode of every slot, each at its own position, updating the
pool in place.  A slot's tokens are the same as in
a batch-1 decode (pinned in tests/test_torch_serve.py).

The global batch every worker builds alike (``make_lm_batch``, and a
frontend configuration's ``frontend`` embeddings) is cut on its batch dim
into the workers' shards by ``Collectives.local_rows``: worker-stacked on
the in-process mesh, this rank's own rows under a process group.

FSDP (``param_mode='fsdp'``): each parameter leaf is split over the
workers along its FSDP dim (:func:`fsdp_dims`), gathered for the forward,
and the gather's backward is the robust reduce-scatter
(:func:`repro_torch.core.distributed.make_robust_param_gather_dim`): a
worker's shard gradient is its chunk of the exact median / trimmed mean
of the m workers' gradients.  Under a process group a rank holds only its
shards (and their optimizer state), the ``blocks`` group is gathered one
super-block at a time and every other group whole, as the reference's
providers do.  On the in-process mesh the workers run one after the
other, so one worker's backward cannot meet the others' cotangents: the
params stay the global view (worker w's shard is chunk w along the dim,
as JAX holds a sharded global array), the per-worker gradients are
computed as in the replicated mode, and each leaf (each layer of a
``blocks`` leaf) is then robust-reduce-scattered along its dim, all of
them in one aggregation call.  Both give the same shards bit for bit.

Tensor parallelism (a mesh's ``model`` axis > 1, ``param_mode=
'replicated'``): each weight the partition rules split
(:func:`param_shardings`) is cut into ``model`` shards along its model dim
and the forward runs on them through the mesh's
:class:`~repro_torch.models.sharding.ShardCtx`.  Under a process group a
rank holds its shards (:func:`tp_shard`) and their optimizer moments, and
the strategies aggregate the rank's own leaves over the workers of its
model coordinate; on the in-process mesh the params stay the global view
(worker w, model rank k's shard is chunk k along the leaf's model dim)
and the strategies aggregate the global view, which gives the shards'
bits since the estimators are coordinate-wise.  ``grad_norm`` psums the
split leaves' squares over ``model`` and counts a replicated leaf once.
Every configuration trains on the model axis, the ``ssm`` / ``rec``
families and the frontends included, and so does everything else the
reference's step runs there:

- fsdp: a leaf is split over the workers on its FSDP dim and over
  ``model`` on its model dim (:func:`fsdp_param_shardings`); under a
  process group rank (w, k) holds FSDP chunk w of model chunk k
  (:func:`fsdp_rank_shard`) and gathers it over the workers of its model
  coordinate, and a leaf whose FSDP dim took its model dim ("the model
  yields", :func:`fsdp_model_dims`) is stored whole over ``model`` and
  cut to the rank's model chunk after the gather; in process the global
  view is reduce-scattered along the FSDP dims as at model 1;
- ``seq_parallel``: the blocks' residual split over ``model`` along S
  (:class:`~repro_torch.models.sharding.ShardCtx`), bitwise the step
  without it;
- the codecs: a worker's message is its whole raveled gradient, so a
  rank holding shards gathers its leaves over ``model`` for the codec and
  keeps its chunks of the decoded tree
  (:func:`repro_torch.rounds.distributed.compress_workers`); the
  error-feedback residual is the whole (D,) row on each model rank;
- randomized attacks: each payload is drawn over the whole leaf and cut
  to the rank's chunk.

The serving steps run on the model axis too: the prefill and decode steps
over the mesh's ``ShardCtx`` (never sequence parallel), the slot pool's kv
heads split over ``model`` (:func:`init_slot_pool`); a frontend
configuration is not served there (ROADMAP queue A item 6, step 8).

Activation checkpointing (``ParallelConfig.remat``): the step's loss runs
each super-block and each encoder layer under ``torch.utils.checkpoint``
(:mod:`repro_torch.models.transformer`), FSDP's per-block gather inside
it, so neither their activations nor the gathered weights are kept for
the backward; the recompute changes no bit of the gradients.
:func:`input_specs` and :func:`cache_shardings` are the reference's
dry-run specs, as spec tuples on meta tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import rng, trace
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core import distributed
from repro_torch.core.attacks import AttackConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer
from repro_torch.rounds import comm
from repro_torch.rounds import compression as comp_lib
from repro_torch.rounds import distributed as rounds_dist
from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                              tree_map_with_path, tree_unflatten_like)

#: key bases of the step: codecs fold the step into _COMP_KEY (the
#: reference's PRNGKey(11)); attacks fold it into the run's base key
_COMP_KEY = 11


# ---------------------------------------------------------------------------
# sharding helpers: one spec (a tuple, an axis name or None per dim) or one
# FSDP dim per parameter leaf, in trees shaped like the params
# ---------------------------------------------------------------------------


def _batch_entry(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def _model_size(mesh: mesh_lib.Mesh) -> int:
    return mesh_lib.mesh_shape_dict(mesh).get("model", 1)


def param_shardings(cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """The replicated params' specs: the model-axis rules of
    :mod:`repro_torch.models.sharding` at the mesh's model size."""
    return sharding.tree_partition_specs(T.meta_params(cfg), "model", _model_size(mesh))


def tp_shard(tree, specs, k: int, model: int):
    """Model rank ``k``'s shards of a full parameter tree (or of a tree
    shaped like it, the optimizer's moments): chunk ``k`` of ``model``
    along each leaf's ``model`` entry of ``specs``, copied so the full
    tensor can be freed; a leaf with no model entry as it is.  At model
    size 1 the tree itself."""
    if model == 1:
        return tree

    def cut(t, spec):
        d = next((i for i, e in enumerate(spec) if e == "model"), None)
        return t if d is None else t.chunk(model, d)[k].clone(
            memory_format=torch.contiguous_format)

    return tree_map(cut, tree, specs)


def abstract_params(cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """The replicated params as tensors on the meta device: a rank's shard
    shapes under a process group with a model axis, else the whole."""
    meta = T.meta_params(cfg)
    if not mesh.per_rank:
        return meta
    return tp_shard(meta, param_shardings(cfg, mesh), 0, _model_size(mesh))


def abstract_opt_state(opt: Optimizer, cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """The optimizer state of the replicated params on the meta device."""
    return opt.init(abstract_params(cfg, mesh))


def fsdp_dims(cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """The FSDP dim of every parameter leaf: its largest dim divisible by
    the worker count (ties to the last), never dim 0 of a layer-stacked
    group's leaf, and never the dim the model axis takes
    (:func:`param_shardings`) unless no other dim qualifies; -1 where none
    does (the leaf stays replicated)."""
    m = mesh_lib.num_workers(mesh)
    mm = _model_size(mesh)

    def visit(path, leaf):
        shape = tuple(leaf.shape)
        stacked = path.split("/")[0] in ("blocks",) + _STACKED  # dim 0 the layers
        spec = sharding.param_partition_spec(path, shape, "model", mm)
        model_dim = next((i for i, e in enumerate(spec) if e == "model"), None)

        def cands(avoid):
            return [(size, d) for d, size in enumerate(shape)
                    if size % m == 0 and size >= m and not (stacked and d == 0)
                    and d != avoid]

        best = cands(model_dim) or cands(None)  # the model dim yields last
        return max(best)[1] if best else -1

    return tree_map_with_path(visit, T.meta_params(cfg))


def fsdp_param_shardings(cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """(specs, dims): the model-axis specs with the worker axes on each
    leaf's FSDP dim (the model axis yields there), and :func:`fsdp_dims`."""
    dims = fsdp_dims(cfg, mesh)
    entry = _batch_entry(mesh_lib.worker_axes(mesh))
    meta = T.meta_params(cfg)

    def combine(leaf, spec, dim):
        entries = list(spec)
        if dim >= 0:
            entries[dim] = entry
        return tuple(entries)

    return tree_map(combine, meta, param_shardings(cfg, mesh), dims), dims


def fsdp_manual_specs(cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """The worker-axes-only specs of the FSDP params (the reference's
    shard_map in_specs)."""
    entry = _batch_entry(mesh_lib.worker_axes(mesh))
    return tree_map(lambda leaf, dim: tuple(entry if d == dim else None
                                            for d in range(leaf.dim())),
                    T.meta_params(cfg), fsdp_dims(cfg, mesh))


def fsdp_shard(tree, dims, index: int, m: int):
    """Worker ``index``'s shards of a full parameter tree (or of a tree
    shaped like it, the optimizer's moments): chunk ``index`` of m along
    each leaf's FSDP dim, copied so the full tensor can be freed; a
    replicated leaf (dim -1) as it is."""
    return tree_map(lambda t, d: t if d < 0 else
                    t.chunk(m, d)[index].clone(memory_format=torch.contiguous_format),
                    tree, dims)


def fsdp_model_dims(cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """The model dim each FSDP leaf is stored split on over the model axis:
    its tensor-parallel dim (:func:`repro_torch.models.sharding.tp_dims`),
    except where its FSDP dim took that dim ("the model yields", as in
    :func:`fsdp_param_shardings`): such a leaf is stored split over the
    workers and whole over ``model``, the reference's layout; -1 where the
    leaf is whole over the model axis."""
    return tree_map(lambda t, f: -1 if t == f else t,
                    sharding.tp_dims(cfg, _model_size(mesh)), fsdp_dims(cfg, mesh))


def fsdp_rank_shard(tree, cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """A process-group rank's part of a full parameter tree (or of a tree
    shaped like it, the optimizer's moments) under fsdp: chunk (model
    rank) along each leaf's :func:`fsdp_model_dims` entry, then chunk
    (worker) along its FSDP dim, copied so the full tensor can be freed; a
    leaf split by neither as it is.  At model size 1 :func:`fsdp_shard`."""
    model, m = _model_size(mesh), mesh_lib.num_workers(mesh)
    w, k = mesh_lib.worker_index(mesh), mesh_lib.model_rank(mesh)

    def cut(t, md, fd):
        if md < 0 and fd < 0:
            return t
        if md >= 0:
            t = t.chunk(model, md)[k]
        if fd >= 0:
            t = t.chunk(m, fd)[w]
        return t.clone(memory_format=torch.contiguous_format)

    return tree_map(cut, tree, fsdp_model_dims(cfg, mesh), fsdp_dims(cfg, mesh))


def abstract_params_fsdp(cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """The FSDP params on the meta device: the global shapes on the
    in-process mesh (its params are the global view), a rank's shard
    shapes under a process group (:func:`fsdp_rank_shard`)."""
    meta = T.meta_params(cfg)
    if not mesh.per_rank:
        return meta
    return fsdp_rank_shard(meta, cfg, mesh)


def abstract_opt_state_fsdp(opt: Optimizer, cfg: ModelConfig, mesh: mesh_lib.Mesh):
    """The optimizer state of :func:`abstract_params_fsdp`."""
    return opt.init(abstract_params_fsdp(cfg, mesh))


def _divisible_spec(mesh: mesh_lib.Mesh, shape, prefs) -> tuple:
    """A spec giving mesh axes to dims where they divide them.  ``prefs``:
    (dim, axes tuple or axis) preferences in order; an axis is used once."""
    shp = mesh_lib.mesh_shape_dict(mesh)
    spec = [None] * len(shape)
    used = set()
    for dim, axes in prefs:
        axes_t = axes if isinstance(axes, tuple) else (axes,)
        if any(a in used or a not in shp for a in axes_t):
            continue
        size = 1
        for a in axes_t:
            size *= shp[a]
        if shape[dim] % size == 0 and shape[dim] >= size:
            spec[dim] = axes_t if len(axes_t) > 1 else axes_t[0]
            used.update(axes_t)
    return tuple(spec)


def cache_shardings(cfg: ModelConfig, mesh: mesh_lib.Mesh, cache):
    """The serving caches' specs (a tree shaped like ``cache``, whose leaves
    may be meta tensors): batch over the worker axes, heads (else head
    dim, state heads or channels) over the model axis where they divide;
    ``()`` (replicated) for the rest."""
    del cfg
    waxes = mesh_lib.worker_axes(mesh)

    def visit(path, leaf):
        name = path.split("/")[-1] if path else ""
        shape = tuple(leaf.shape)
        n = len(shape)
        if name in ("k", "v") and n >= 4:  # (.., B, S, KV, hd)
            return _divisible_spec(mesh, shape, [(n - 4, waxes), (n - 2, "model"),
                                                 (n - 1, "model")])
        if name == "ssd" and n >= 4:
            return _divisible_spec(mesh, shape, [(n - 4, waxes), (n - 3, "model")])
        if name in ("conv", "h") and n >= 2:
            return _divisible_spec(mesh, shape, [(n - (3 if name == "conv" else 2), waxes),
                                                 (n - 1, "model")])
        return ()

    return tree_map_with_path(visit, cache)


def long_context_cfg(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """For ``long_500k`` on a full-attention architecture with a documented
    sliding-window decode variant (``long_context_window``), that variant,
    named ``cfg.name + "+swa"`` (the reference's DESIGN.md §Input-shape
    handling); every other combination as it is."""
    if shape.name == "long_500k" and cfg.long_context_window and not cfg.sliding_window:
        return dataclasses.replace(cfg, name=cfg.name + "+swa")
    return cfg


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """A step input's stand-in: a meta tensor (shape and dtype, nothing
    allocated) and its spec tuple (a leaf of the port's trees)."""

    meta: torch.Tensor
    spec: tuple


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: mesh_lib.Mesh) -> Dict[str, Any]:
    """Stand-ins for the step inputs of an (arch × shape) combination, the
    reference's dry-run ``input_specs``: ``tokens``/``labels`` (B, S) int32
    over the worker axes, a frontend configuration's ``frontend`` (B, T,
    D); for decode the ``token`` (B, 1), the ``cache`` tree (its specs
    :func:`cache_shardings`) and the scalar ``pos``."""
    waxes = mesh_lib.worker_axes(mesh)
    bspec = (_batch_entry(waxes),)
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = InputSpec(meta((b, s), torch.int32), bspec)
        if shape.kind == "train":
            out["labels"] = InputSpec(meta((b, s), torch.int32), bspec)
        if cfg.frontend != "none":
            out["frontend"] = InputSpec(meta((b, cfg.n_frontend_tokens, cfg.d_model),
                                             getattr(torch, cfg.dtype)), bspec)
    else:  # decode
        out["token"] = InputSpec(meta((b, 1), torch.int32),
                                 _divisible_spec(mesh, (b, 1), [(0, waxes)]))
        cache = T.init_cache(cfg, b, s, device="meta")
        out["cache"] = tree_map(InputSpec, cache, cache_shardings(cfg, mesh, cache))
        out["pos"] = InputSpec(meta((), torch.int32), ())
    return out


# ---------------------------------------------------------------------------
# train step (Algorithm 1 over the worker axis)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepBody:
    """The validated train-step body over a mesh's worker axes ``waxes``.

    ``body(params, opt_state, batch, step, atk_base) -> (params, opt_state,
    metrics)``: ``batch`` is the global batch (worker w's shard is rows
    [w·B/m, (w+1)·B/m)), ``step`` the host step index and ``atk_base`` the
    integer key randomized attacks fold the step into.  ``metrics`` holds
    the workers' mean ``loss`` and the aggregate's ``grad_norm`` as 0-dim
    tensors on the params' device.

    Error-feedback compression (``compression='topk'``) needs per-worker
    residual state: ``comp_body(params, opt_state, comp, batch, step,
    atk_base) -> (params, opt_state, comp, metrics)`` threads it (``comp``
    the varying (D,) float32 residuals), and is None for every other
    codec; only the trainer uses it.
    """

    body: Callable
    waxes: Tuple[str, ...]
    comp_body: Any = None


#: the stacked layer groups of a parameter tree: each leaf (n_layers, ...)
_STACKED = ("enc_blocks", "cross_blocks")


def _pieces(params):
    """``params`` with every stacked layer leaf (the blocks', the encoder's
    and the cross-attention's) given as its per-layer views (so each
    layer's gradient comes out at its own size, not as a stacked-size zero
    tensor per layer); the other leaves, the tail's included, as they are."""
    return _stacked_pieces(params, 0)


def _stacked_pieces(buf, k: int):
    """A parameter tree, or the worker-stacked gradient buffer, in
    :func:`_pieces` form: per-layer views of its stacked leaves (the layer
    dim follows the ``k`` worker dims)."""
    out = dict(buf)
    out["blocks"] = {key: {n: tuple(v.unbind(k)) for n, v in group.items()}
                     for key, group in buf["blocks"].items()}
    for key in _STACKED:
        if key in buf:
            out[key] = {n: tuple(v.unbind(k)) for n, v in buf[key].items()}
    return out


def _value_and_grad(cfg: ModelConfig, kv_block: int, transform: Optional[Callable] = None,
                    block_provider: Optional[Callable] = None,
                    ctx: sharding.ShardCtx = sharding.NULL_CTX, remat: bool = True):
    """``vg(pieces, batch) -> (loss, grads)``: the gradient of every leaf of
    ``pieces`` (exact zeros where the loss does not read it, as JAX gives);
    ``transform`` maps the leaves to the tree the model runs with, ``ctx``
    is the model axis it runs over, ``remat`` checkpoints its super-blocks
    and encoder layers."""
    def vg(pieces, batch):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(pieces)]
        tree = tree_unflatten_like(pieces, leaves)
        loss = T.loss_fn(tree if transform is None else transform(tree), batch, cfg,
                         kv_block=kv_block, block_provider=block_provider, ctx=ctx,
                         remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
        return loss.detach(), tree_unflatten_like(pieces, grads)

    return vg


def _fsdp_providers(ax, waxes, dims, yields, pcfg: ParallelConfig, attack):
    """(transform, block_provider) over a rank's shards, the reference's
    ``_make_providers``: every group but ``blocks`` gathered whole by
    ``transform`` (the stacked encoder and cross groups then unbound per
    layer), each super-block of ``blocks`` by ``block_provider`` in the
    forward (its dims lose the stacking dim).  A gathered tensor the loss
    does not read never runs its backward, so its shard's gradient is the
    trainer's exact zeros, with no collective on any rank.

    Under a model axis a rank gathers its model chunk of each leaf over
    the workers of its model coordinate; a leaf whose FSDP dim took its
    model dim (``yields``, that dim, else -1) is stored whole over
    ``model``, so the rank cuts its model chunk after the gather
    (``Collectives.model_cut``: the gradient of the whole, gathered from
    the ranks' chunks, then meets the workers' reduce-scatter)."""
    def gather(dim, cut=-1):
        if dim < 0:
            return lambda w: w
        g = distributed.make_robust_param_gather_dim(ax, waxes, dim, pcfg.agg_method,
                                                     pcfg.agg_beta, attack)
        return g if cut < 0 else (lambda w: ax.model_cut(g(w), cut))

    def layer(d):  # a ``blocks`` leaf's dim in one super-block's slice
        return d - 1 if d >= 0 else -1

    def block_provider(block):
        return {key: {n: gather(layer(dims["blocks"][key][n]),
                                layer(yields["blocks"][key][n]))(w)
                      for n, w in group.items()}
                for key, group in block.items()}

    def transform(tree):
        out = {}
        for key, group in tree.items():
            if key == "blocks":
                out[key] = group  # gathered a super-block at a time in the forward
                continue
            full = tree_map(lambda w, d, y: gather(d, y)(w), group, dims[key], yields[key])
            out[key] = ({n: tuple(t.unbind(0)) for n, t in full.items()} if key in _STACKED
                        else full)
        return out

    return transform, block_provider


def _global_view(shards: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """The tensor whose chunk w along ``dim`` is worker w's shard, from the
    in-process shards of :func:`repro_torch.core.distributed.robust_reduce_scatter_dims`
    (k worker dims, row-major = the bucket order): a view of them."""
    rows = shards.flatten(0, k - 1) if k > 1 else shards
    return rows.movedim(1 + dim, 1).flatten(0, 1).movedim(0, dim)


def make_step_body(cfg: ModelConfig, pcfg: ParallelConfig, mesh: mesh_lib.Mesh,
                   opt: Optimizer, attack: Optional[AttackConfig] = None) -> StepBody:
    """Build (and validate) the per-step body shared by
    :func:`make_train_step` and the trainer's window.

    All build-time validation lives here (attack access vs strategy,
    adaptive and fsdp-randomized rejections, codec and local-steps
    constraints, fsdp with a codec or local steps), as in the reference.
    ``pcfg.remat`` (default True, as the reference's) runs each
    super-block of the loss, FSDP's per-block gather inside it, and each
    encoder layer under ``torch.utils.checkpoint``: their activations and
    gathered weights are recomputed in the backward instead of kept.  The
    robust reduce-scatter, the gather's backward, still runs once a step,
    and the gradients are bitwise those of ``remat=False``.

    ``param_mode='fsdp'`` (module docstring): the params (and the optimizer
    state) are the global view on the in-process mesh and a rank's shards
    under a process group.  Sharded leaves arrive aggregated by the robust
    reduce-scatter; replicated ones (FSDP dim -1) take the gather strategy
    with the step's attack key; ``grad_norm`` psums each worker's sum of
    squares over the workers, so a replicated leaf counts m times, as in
    the reference.

    A model axis > 1 (module docstring) runs the forward over the mesh's
    :func:`~repro_torch.models.sharding.model_ctx`, for every
    configuration, with fsdp, ``seq_parallel``, the codecs and randomized
    attacks.  ``grad_norm`` under fsdp there: each worker's sum of squares
    of the shards it holds, a leaf split over ``model``
    (:func:`fsdp_model_dims`) psummed over the model axis and a leaf whole
    over it counted once, then psummed over the workers (a replicated leaf
    still counted m times), the reference's GSPMD sum.  A leaf-global
    attack (mimic) with the bucketed strategies, fsdp's reduce-scatter
    among them, is a ``ValueError``
    (:func:`repro_torch.rounds.comm.refuse_leaf_global`): their buckets
    are slices of a rank's own shards."""
    fsdp = pcfg.param_mode == "fsdp"
    model = _model_size(mesh)
    comm.refuse_leaf_global(attack, pcfg.agg_strategy, model)
    if fsdp:
        comm.refuse_leaf_global(attack, "rs", model)
    if attack is not None and attack.name != "none" and attack.alpha > 0:
        atk_spec, _ = attack.resolve()  # raises early on unknown names
        comm.validate_attack_strategy(attack, pcfg.agg_strategy)
        if atk_spec.adaptive:
            raise ValueError(
                f"attack {attack.name!r} is adaptive (reads the previous "
                "aggregate), which the distributed train step does not "
                "thread; use core.robust_gd or repro_torch.fed for adaptive attacks")
        if atk_spec.randomized and fsdp:
            raise ValueError(
                f"attack {attack.name!r} is randomized; the fsdp backward-pass "
                "attack path has no per-step key — use agg_strategy gather/"
                "bucketed/chunked with param_mode='replicated'")
    if pcfg.param_mode not in ("replicated", "fsdp"):
        raise ValueError(f"unknown param_mode {pcfg.param_mode!r}")
    spec = comp_lib.get_compression(pcfg.compression)  # validates the name
    ef = spec.error_feedback
    if pcfg.compression != "none" and fsdp:
        raise ValueError(
            "compression needs param_mode='replicated': the fsdp path fuses "
            "robust aggregation into the parameter-gather backward, so there "
            "is no transmitted gradient payload to encode")
    tau = pcfg.local_steps
    if tau < 1:
        raise ValueError(f"local_steps must be >= 1, got {tau}")
    if tau > 1 and fsdp:
        raise ValueError(
            "local_steps > 1 needs param_mode='replicated': the fsdp "
            "robust reduce-scatter fires a collective per local step")
    agg_dtype = getattr(torch, pcfg.agg_dtype) if pcfg.agg_dtype else None
    ax = mesh.axes
    waxes = mesh_lib.worker_axes(mesh)
    m = mesh_lib.num_workers(mesh)
    vs = ax.vshape(waxes)
    k = len(vs)
    ctx = sharding.model_ctx(mesh, pcfg.seq_parallel)
    vg = _value_and_grad(cfg, pcfg.attn_chunk, ctx=ctx, remat=pcfg.remat)
    mdims = tree_leaves(sharding.tp_dims(cfg, model)) if model > 1 else None

    def sq_norm(agg):
        """The aggregate's squared norm: the split leaves' squares summed a
        model rank at a time and psummed over ``model``, each replicated
        leaf counted once."""
        leaves = tree_leaves(agg)
        if mdims is None:
            return sum(torch.sum(g.float() ** 2) for g in leaves)
        parts = [sum(torch.sum(ax.model_shard(g, d, r).float() ** 2)
                     for g, d in zip(leaves, mdims) if d >= 0) for r in ax.model_ranks()]
        return ax.model_sum(parts) + sum(torch.sum(g.float() ** 2)
                                         for g, d in zip(leaves, mdims) if d < 0)
    buf = {}  # the worker-stacked gradients, allocated at the first step

    @trace.spanned("worker.fwd_bwd")
    def local(w, batch, pieces):
        if tau == 1:
            return vg(pieces, batch)
        # a communication round: tau local SGD steps on this worker's shard,
        # the accumulated local gradient transmitted once
        delta, loss = rounds_dist.scan_local_sgd(lambda p: vg(p, batch), pieces, tau,
                                                 pcfg.local_lr)
        return loss, delta

    @trace.spanned("worker.grads")
    def worker_grads(params, batch):
        """(losses (vs), grads tree of (vs + shape) leaves) of every worker."""
        if "g" not in buf or any(b.shape != vs + p.shape or b.dtype != p.dtype
                                 for b, p in zip(tree_leaves(buf["g"]), tree_leaves(params))):
            buf.clear()
            buf["g"] = tree_map(lambda p: torch.empty(vs + p.shape, dtype=p.dtype,
                                                      device=p.device), params)
            buf["loss"] = torch.empty(vs, dtype=torch.float32, device=mesh.device)
        vbatch = {key: ax.local_rows(v, waxes) for key, v in batch.items()}
        pieces = _pieces(params)
        ax.map_workers(lambda w, bt: local(w, bt, pieces), waxes, vbatch,
                       out=(buf["loss"], _stacked_pieces(buf["g"], len(vs))))
        return buf["loss"], buf["g"]

    def _core(params, opt_state, comp, batch, step: int, atk_base: int):
        losses, grads = worker_grads(params, batch)
        with torch.no_grad():
            atk_key = rng.fold(atk_base, step)
            if ef:
                # transmit decode(encode(g + e)) per worker and keep the new
                # residual, each written over its input (a worker's whole
                # (D,) f32 residual is the step's largest buffer); the
                # strategy then moves already-decoded rows
                grads, comp = rounds_dist.compress_workers(
                    ax, waxes, grads, pcfg.compression, comp_key=rng.fold(_COMP_KEY, step),
                    residual=comp, model_dims=mdims, out=(grads, comp))
                agg = rounds_dist.aggregate_by_strategy(
                    grads, ax, waxes, pcfg.agg_strategy, pcfg.agg_method, pcfg.agg_beta,
                    attack, agg_dtype, attack_key=atk_key)
            else:
                agg = rounds_dist.aggregate_by_strategy(
                    grads, ax, waxes, pcfg.agg_strategy, pcfg.agg_method, pcfg.agg_beta,
                    attack, agg_dtype, attack_key=atk_key, compression=pcfg.compression,
                    comp_key=rng.fold(_COMP_KEY, step), model_dims=mdims)
            if tau > 1:
                # the optimizer gets the MEAN local gradient, so lr means what
                # it means at tau = 1 (scaling commutes with the aggregators)
                agg = tree_map(lambda g: g / tau, agg)
            new_params, new_opt = opt.update(agg, opt_state, params, step)
            metrics = {"loss": ax.psum(losses, waxes) / m, "grad_norm": torch.sqrt(sq_norm(agg))}
        return new_params, new_opt, comp, metrics

    if fsdp:
        dims = fsdp_dims(cfg, mesh)
        tdims = sharding.tp_dims(cfg, model)
        yields = tree_map(lambda t, f: t if model > 1 and t == f else -1, tdims, dims)
        sdims = tree_leaves(fsdp_model_dims(cfg, mesh))  # split over model as stored
        pg_vg = _value_and_grad(cfg, pcfg.attn_chunk,
                                *_fsdp_providers(ax, waxes, dims, yields, pcfg, attack),
                                ctx=ctx, remat=pcfg.remat)

        def rank_grads(params, batch):
            """This rank's loss and its shards' gradients: the sharded
            leaves' already aggregated by the gathers' backward."""
            pieces = dict(params)
            pieces["blocks"] = {key: {n: tuple(v.unbind(0)) for n, v in group.items()}
                                for key, group in params["blocks"].items()}
            loss, g = pg_vg(pieces, {key: ax.local_rows(v, waxes) for key, v in batch.items()})
            g["blocks"] = {key: {n: torch.stack(t) for n, t in group.items()}
                           for key, group in g["blocks"].items()}
            return loss, g

        def sq_sum(t):
            """Each worker's sum of squares of its shard ``t``."""
            return (t.float() ** 2).reshape(vs + (-1,)).sum(-1)

        def sq_parts(t, md, lead):
            """:func:`sq_sum` of ``t`` (``lead`` leading dims before the
            leaf's) by model rank: one part a rank this process computes
            where the leaf is split along ``md`` over ``model``, else one."""
            if md < 0:
                return [sq_sum(t)]
            return [sq_sum(ax.model_shard(t, lead + md, r)) for r in ax.model_ranks()]

        def reduce_scatter_in_process(grads):
            """The worker-stacked gradients' sharded leaves robust-reduce-
            scattered along their dims (a ``blocks`` leaf layer by layer, as
            the reference gathers them), all in one aggregation call: (the
            global view of each leaf's aggregate, each worker's sum of
            squares of its shards of it), by leaf index."""
            leaves, dl = tree_leaves(grads), tree_leaves(dims)
            paths = [p for p, _ in tree_leaves_with_path(grads)]
            cts, cdims, mds, owner = [], [], [], []
            for i, (path, g, d) in enumerate(zip(paths, leaves, dl)):
                if d < 0:
                    continue
                layers = range(g.shape[k]) if path.startswith("blocks/") else [None]
                for s in layers:
                    cts.append(g if s is None else g.select(k, s))
                    cdims.append(d if s is None else d - 1)
                    mds.append(sdims[i] if s is None or sdims[i] < 0 else sdims[i] - 1)
                    owner.append(i)
            shards = distributed.robust_reduce_scatter_dims(
                cts, cdims, ax, waxes, pcfg.agg_method, pcfg.agg_beta, attack)
            views, sqs = {}, {}
            for i, sh, d, md in zip(owner, shards, cdims, mds):
                views.setdefault(i, []).append(_global_view(sh, k, d))
                parts = sq_parts(sh, md, k)
                sqs[i] = [a + b for a, b in zip(sqs[i], parts)] if i in sqs else parts
            for i, v in views.items():
                views[i] = torch.stack(v) if paths[i].startswith("blocks/") else v[0]
            return views, sqs

        def fsdp_core(params, opt_state, comp, batch, step: int, atk_base: int):
            if mesh.per_rank:
                losses, grads = rank_grads(params, batch)
            else:
                losses, grads = worker_grads(params, batch)
            with torch.no_grad():
                leaves, dl = tree_leaves(grads), tree_leaves(dims)
                rep = [i for i, d in enumerate(dl) if d < 0]
                rep_agg = distributed.robust_gather_agg(
                    [leaves[i] for i in rep], ax, waxes, pcfg.agg_method, pcfg.agg_beta,
                    attack, agg_dtype, attack_key=rng.fold(atk_base, step)) if rep else []
                if mesh.per_rank:
                    views = {i: g for i, (g, d) in enumerate(zip(leaves, dl)) if d >= 0}
                    sqs = {i: [sq_sum(g)] for i, g in views.items()}
                else:
                    views, sqs = reduce_scatter_in_process(grads)
                    # the worker-stacked gradients are not read again this
                    # step: released, so the update can use their memory
                    buf.clear()
                del grads, leaves
                for i, a in zip(rep, rep_agg):
                    views[i] = a
                    sqs[i] = [torch.sum(t.float() ** 2) for t in (
                        [a] if sdims[i] < 0 else [ax.model_shard(a, sdims[i], r)
                                                  for r in ax.model_ranks()])]
                # each worker's sum of squares over its shards (a replicated
                # leaf whole; under a model axis a split leaf's parts summed
                # a model rank at a time and psummed over ``model``, a leaf
                # whole over it once), psummed over the workers
                sq = torch.zeros(vs, dtype=torch.float32, device=mesh.device)
                if model == 1:
                    for i in range(len(dl)):
                        sq = sq + sqs[i][0]
                else:
                    split = [torch.zeros(vs, dtype=torch.float32, device=mesh.device)
                             for _ in ax.model_ranks()]
                    for i in range(len(dl)):
                        if sdims[i] < 0:
                            sq = sq + sqs[i][0]
                        else:
                            split = [a + b for a, b in zip(split, sqs[i])]
                    sq = ax.model_sum(split) + sq
                agg = tree_unflatten_like(params, [views[i] for i in range(len(dl))])
                del views
                new_params, new_opt = opt.update(agg, opt_state, params, step)
                metrics = {"loss": ax.psum(losses, waxes) / m,
                           "grad_norm": torch.sqrt(ax.psum(sq, waxes))}
            return new_params, new_opt, comp, metrics

    step_core = fsdp_core if fsdp else _core

    def core(params, opt_state, comp, batch, step: int, atk_base: int):
        with trace.span("step", step):
            return step_core(params, opt_state, comp, batch, step, atk_base)

    def body(params, opt_state, batch, step: int, atk_base: int):
        new_params, new_opt, _, metrics = core(params, opt_state, None, batch, step, atk_base)
        return new_params, new_opt, metrics

    return StepBody(body=body, waxes=waxes, comp_body=core if ef else None)


def comp_state_size(cfg: ModelConfig) -> int:
    """Flat parameter count D: the width of one worker's error-feedback
    residual (the payload is the whole gradient raveled to one message)."""
    return T.count_params(cfg)


def init_comp_state(cfg: ModelConfig, pcfg: ParallelConfig, mesh: mesh_lib.Mesh):
    """float32 zeros, one (D,) residual per worker (varying), for
    error-feedback codecs; ``()`` otherwise."""
    if not comp_lib.get_compression(pcfg.compression).error_feedback:
        return ()
    vs = mesh.axes.vshape(mesh_lib.worker_axes(mesh))
    return torch.zeros(vs + (comp_state_size(cfg),), dtype=torch.float32, device=mesh.device)


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig, mesh: mesh_lib.Mesh,
                    opt: Optimizer, attack: Optional[AttackConfig] = None) -> Callable:
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` with robust aggregation over the workers; randomized attacks
    fold the step into the fixed base key 0.  Error-feedback codecs are
    rejected (this step is stateless; the trainer threads the residual)."""
    comp_lib.validate_compression_context(
        pcfg.compression, stateful=False, where="the stateless train step")
    sb = make_step_body(cfg, pcfg, mesh, opt, attack)

    def step(params, opt_state, batch, step_idx: int):
        return sb.body(params, opt_state, batch, int(step_idx), 0)

    return step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def _serving_ctx(mesh: Optional[mesh_lib.Mesh]) -> sharding.ShardCtx:
    """The model axis the serving steps run over (:data:`NULL_CTX` without a
    mesh or at model size 1)."""
    return sharding.NULL_CTX if mesh is None else sharding.model_ctx(mesh)


def _splits_rows(mesh: Optional[mesh_lib.Mesh], b: int) -> bool:
    """Whether a process-group rank holds its block of a batch of ``b`` rows
    (``cache_shardings``' rule: the batch divides over the workers)."""
    if mesh is None or not mesh.per_rank:
        return False
    m = mesh_lib.num_workers(mesh)
    return m > 1 and b % m == 0


def make_prefill_step(cfg: ModelConfig, kv_block: int = 1024,
                      cache_len: Optional[int] = None,
                      mesh: Optional[mesh_lib.Mesh] = None) -> Callable:
    """``step(params, tokens, frontend=None) -> (last-token logits, cache)``,
    the reference's layout: the batch over the worker axes and the kv heads
    over the model axis.  On the in-process mesh ``params`` and the results
    are the global view; under a process group ``params`` are the rank's
    shards (:func:`tp_shard`), ``tokens`` the global batch every rank
    holds alike, and the rank returns its block of rows (where the batch
    divides over the workers) with its kv heads of the cache: the slice
    :func:`cache_shardings` names.  Its logits are whole over V."""
    ctx = _serving_ctx(mesh)
    waxes = mesh_lib.worker_axes(mesh) if mesh is not None else ()

    def step(params, tokens, frontend=None):
        if _splits_rows(mesh, tokens.shape[0]):
            tokens = mesh.axes.local_rows(tokens, waxes)
            if frontend is not None:
                frontend = mesh.axes.local_rows(frontend, waxes)
        with torch.no_grad():
            return T.prefill(params, tokens, cfg, frontend=frontend, kv_block=kv_block,
                             cache_len=cache_len, ctx=ctx)

    return step


def make_decode_step(cfg: ModelConfig, mesh: Optional[mesh_lib.Mesh] = None) -> Callable:
    """``step(params, token, cache, pos) -> (logits, cache)``, the cache
    updated in place; ``token`` and ``cache`` as :func:`make_prefill_step`'s
    step returns them (under a process group the rank's rows and heads)."""
    ctx = _serving_ctx(mesh)

    def step(params, token, cache, pos):
        with torch.no_grad():
            return T.decode_step(params, token, cache, pos, cfg, ctx)

    return step


def make_slot_prefill_step(cfg: ModelConfig, cache_len: int,
                           mesh: Optional[mesh_lib.Mesh] = None) -> Callable:
    """Batch-1 prefill at a fixed prompt bucket -> (last-token logits
    (1, 1, V), a slot cache sized ``cache_len``): no batch axes (the pool is
    replicated over the workers, as the reference's ``_serve_ctx`` has it),
    the kv heads over the model axis."""
    ctx = _serving_ctx(mesh)

    def step(params, tokens, frontend=None):
        with torch.no_grad():
            return T.prefill(params, tokens, cfg, frontend=frontend, kv_block=0,
                             cache_len=cache_len, ctx=ctx)

    return step


def make_decode_pool_step(cfg: ModelConfig, mesh: Optional[mesh_lib.Mesh] = None) -> Callable:
    """``tick(params, tokens (S,) or (S, 1[, 1]), pool, pos (S,)) ->
    (next_tokens (S,) int32, pool)``: one greedy decode step of every slot
    at its own position, the pool updated in place.  Idle slots decode
    garbage against their masked caches; the engine ignores their outputs
    and every admit replaces a slot's cache wholesale.  Under a model axis
    the argmax is taken on the whole logits (under a process group one
    all-gather of the (S, V/M) vocab shards a tick, where V splits), so
    ``torch.argmax``'s first-index rule holds as at model 1."""
    ctx = _serving_ctx(mesh)

    def tick(params, tokens, pool, pos):
        with torch.no_grad():
            logits, pool = T.decode_step(params, tokens.reshape(-1, 1), pool, pos, cfg, ctx)
        return torch.argmax(logits[:, 0, :].float(), dim=-1).to(torch.int32), pool

    return tick


def make_slot_admit_step() -> Callable:
    """``admit(pool, one, slot) -> pool``: copy a freshly prefilled batch-1
    cache (:func:`transformer.prefill`'s layout) into slot ``slot`` of the
    pool, in place: every leaf of the slot (attention keys, values and
    positions, recurrent states) is replaced wholesale.  The copy keeps the
    pool's storage and layout (the reference pins its pool replicated to
    the same end); a slot cache of another shape (another rank's heads)
    raises rather than broadcast."""

    def put(dst, src, slot: int, lead: int):
        for name, d in dst.items():  # the slot axis follows ``lead`` block dims
            s = src[name] if name == "kpos" else src[name].select(lead, 0)
            d = d.select(lead, slot)
            if d.shape != s.shape:
                raise ValueError(f"admit: a slot's {name} is {tuple(s.shape)}, the pool's "
                                 f"{tuple(d.shape)}")
            d.copy_(s)

    def admit(pool, one, slot: int):
        for key, group in pool["blocks"].items():
            put(group, one["blocks"][key], slot, 1)
        for dst, src in zip(pool.get("tail", []), one.get("tail", [])):
            put(dst, src, slot, 0)
        return pool

    return admit


def init_slot_pool(cfg: ModelConfig, slots: int, cache_len: int, device="cuda",
                   mesh: Optional[mesh_lib.Mesh] = None):
    """Empty pool caches, :func:`transformer.init_cache` with the slots as its
    batch and a position row per slot: kpos (n_super, slots, eff) in the
    blocks and (slots, eff) in the tail, = -1, so an un-admitted slot
    attends to nothing.

    With a ``mesh`` the pool is replicated over the worker axes (the
    reference's ``_serve_ctx`` has no batch axes) and its attention keys
    and values are split on the kv heads over the model axis
    (:func:`repro_torch.models.sharding.cache_dims`): under a process group
    a rank holds its heads, on the in-process mesh the pool holds every
    head and each model rank reads and writes its heads' slice in turn.
    The ``ssm`` state is split on its heads and the ``rec`` states on
    their channels in the same way; a rank's ``ssm`` conv window holds its
    x channels and B and C whole.
    The reference pins its pool replicated; that is a layout, and the
    function is the same."""
    pool = T.init_cache(cfg, slots, cache_len, device=device)

    def per_slot(group, lead: int):
        kp = group.get("kpos")
        if kp is not None:
            group["kpos"] = kp.unsqueeze(lead).expand(
                kp.shape[:lead] + (slots,) + kp.shape[lead:]).contiguous()

    for group in pool["blocks"].values():
        per_slot(group, 1)
    for group in pool.get("tail", []):
        per_slot(group, 0)
    model = _model_size(mesh) if mesh is not None else 1
    if mesh is None or not mesh.per_rank or model == 1:
        return pool
    dims = sharding.cache_dims(cfg, model, pool, cache_shardings(cfg, mesh, pool))
    return sharding.shard_cache(pool, dims, mesh_lib.model_rank(mesh), model)
