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
the in-process mesh, this rank's own rows under a process group.  FSDP
(``param_mode='fsdp'``) and the dry-run ``input_specs`` wait for later
slices (ROADMAP queue A item 6 step 3, item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.attacks import AttackConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer
from repro_torch.rounds import comm
from repro_torch.rounds import compression as comp_lib
from repro_torch.rounds import distributed as rounds_dist
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

#: key bases of the step: codecs fold the step into _COMP_KEY (the
#: reference's PRNGKey(11)); attacks fold it into the run's base key
_COMP_KEY = 11


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


def _value_and_grad(cfg: ModelConfig, kv_block: int):
    def vg(pieces, batch):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(pieces)]
        loss = T.loss_fn(tree_unflatten_like(pieces, leaves), batch, cfg, kv_block=kv_block)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
        return loss.detach(), tree_unflatten_like(pieces, grads)

    return vg


def make_step_body(cfg: ModelConfig, pcfg: ParallelConfig, mesh: mesh_lib.Mesh,
                   opt: Optimizer, attack: Optional[AttackConfig] = None) -> StepBody:
    """Build (and validate) the per-step body shared by
    :func:`make_train_step` and the trainer's window.

    All build-time validation lives here (attack access vs strategy,
    adaptive and fsdp-randomized rejections, codec and local-steps
    constraints), as in the reference.  ``pcfg.remat`` has no effect: the
    port's forward keeps its activations."""
    if attack is not None and attack.name != "none" and attack.alpha > 0:
        atk_spec, _ = attack.resolve()  # raises early on unknown names
        comm.validate_attack_strategy(attack, pcfg.agg_strategy)
        if atk_spec.adaptive:
            raise ValueError(
                f"attack {attack.name!r} is adaptive (reads the previous "
                "aggregate), which the distributed train step does not "
                "thread; use core.robust_gd or repro_torch.fed for adaptive attacks")
        if atk_spec.randomized and pcfg.param_mode == "fsdp":
            raise ValueError(
                f"attack {attack.name!r} is randomized; the fsdp backward-pass "
                "attack path has no per-step key — use agg_strategy gather/"
                "bucketed/chunked with param_mode='replicated'")
    if pcfg.param_mode == "fsdp":
        raise NotImplementedError(
            "param_mode='fsdp' (the robust reduce-scatter in the backward over the "
            "torch.distributed process group) is not ported yet (ROADMAP queue A item 6, "
            "step 3)")
    if pcfg.param_mode != "replicated":
        raise ValueError(f"unknown param_mode {pcfg.param_mode!r}")
    spec = comp_lib.get_compression(pcfg.compression)  # validates the name
    ef = spec.error_feedback
    tau = pcfg.local_steps
    if tau < 1:
        raise ValueError(f"local_steps must be >= 1, got {tau}")
    agg_dtype = getattr(torch, pcfg.agg_dtype) if pcfg.agg_dtype else None
    ax = mesh.axes
    waxes = mesh_lib.worker_axes(mesh)
    m = mesh_lib.num_workers(mesh)
    vs = ax.vshape(waxes)
    vg = _value_and_grad(cfg, pcfg.attn_chunk)
    buf = {}  # the worker-stacked gradients, allocated at the first step

    def local(w, batch, pieces):
        if tau == 1:
            return vg(pieces, batch)
        # a communication round: tau local SGD steps on this worker's shard,
        # the accumulated local gradient transmitted once
        delta, loss = rounds_dist.scan_local_sgd(lambda p: vg(p, batch), pieces, tau,
                                                 pcfg.local_lr)
        return loss, delta

    def worker_grads(params, batch):
        """(losses (vs), grads tree of (vs + shape) leaves) of every worker."""
        if "g" not in buf or any(b.shape != vs + p.shape or b.dtype != p.dtype
                                 for b, p in zip(tree_leaves(buf["g"]), tree_leaves(params))):
            buf.clear()
            buf["g"] = tree_map(lambda p: torch.empty(vs + p.shape, dtype=p.dtype,
                                                      device=p.device), params)
            buf["loss"] = torch.empty(vs, dtype=torch.float32, device=mesh.device)
        vbatch = {k: ax.local_rows(v, waxes) for k, v in batch.items()}
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
                # residual; the strategy then moves already-decoded rows
                grads, comp = rounds_dist.compress_workers(
                    ax, waxes, grads, pcfg.compression, comp_key=rng.fold(_COMP_KEY, step),
                    residual=comp)
                agg = rounds_dist.aggregate_by_strategy(
                    grads, ax, waxes, pcfg.agg_strategy, pcfg.agg_method, pcfg.agg_beta,
                    attack, agg_dtype, attack_key=atk_key)
            else:
                agg = rounds_dist.aggregate_by_strategy(
                    grads, ax, waxes, pcfg.agg_strategy, pcfg.agg_method, pcfg.agg_beta,
                    attack, agg_dtype, attack_key=atk_key, compression=pcfg.compression,
                    comp_key=rng.fold(_COMP_KEY, step))
            if tau > 1:
                # the optimizer gets the MEAN local gradient, so lr means what
                # it means at tau = 1 (scaling commutes with the aggregators)
                agg = tree_map(lambda g: g / tau, agg)
            new_params, new_opt = opt.update(agg, opt_state, params, step)
            sq = sum(torch.sum(g.float() ** 2) for g in tree_leaves(agg))
            metrics = {"loss": ax.psum(losses, waxes) / m, "grad_norm": torch.sqrt(sq)}
        return new_params, new_opt, comp, metrics

    def body(params, opt_state, batch, step: int, atk_base: int):
        new_params, new_opt, _, metrics = _core(params, opt_state, None, batch, step, atk_base)
        return new_params, new_opt, metrics

    return StepBody(body=body, waxes=waxes, comp_body=_core if ef else None)


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


def make_prefill_step(cfg: ModelConfig, kv_block: int = 1024,
                      cache_len: Optional[int] = None) -> Callable:
    """``step(params, tokens, frontend=None) -> (last-token logits, cache)``."""

    def step(params, tokens, frontend=None):
        with torch.no_grad():
            return T.prefill(params, tokens, cfg, frontend=frontend, kv_block=kv_block,
                             cache_len=cache_len)

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``step(params, token, cache, pos) -> (logits, cache)``, the cache
    updated in place."""

    def step(params, token, cache, pos):
        with torch.no_grad():
            return T.decode_step(params, token, cache, pos, cfg)

    return step


def make_slot_prefill_step(cfg: ModelConfig, cache_len: int) -> Callable:
    """Batch-1 prefill at a fixed prompt bucket -> (last-token logits
    (1, 1, V), a slot cache sized ``cache_len``)."""
    return make_prefill_step(cfg, kv_block=0, cache_len=cache_len)


def make_decode_pool_step(cfg: ModelConfig) -> Callable:
    """``tick(params, tokens (S,) or (S, 1[, 1]), pool, pos (S,)) ->
    (next_tokens (S,) int32, pool)``: one greedy decode step of every slot
    at its own position, the pool updated in place.  Idle slots decode
    garbage against their masked caches; the engine ignores their outputs
    and every admit replaces a slot's cache wholesale."""

    def tick(params, tokens, pool, pos):
        with torch.no_grad():
            logits, pool = T.decode_step(params, tokens.reshape(-1, 1), pool, pos, cfg)
        return torch.argmax(logits[:, 0, :].float(), dim=-1).to(torch.int32), pool

    return tick


def make_slot_admit_step() -> Callable:
    """``admit(pool, one, slot) -> pool``: copy a freshly prefilled batch-1
    cache (:func:`transformer.prefill`'s layout) into slot ``slot`` of the
    pool, in place: every leaf of the slot (attention keys, values and
    positions, recurrent states) is replaced wholesale."""

    def put(dst, src, slot: int, lead: int):
        for name, d in dst.items():  # the slot axis follows ``lead`` block dims
            s = src[name] if name == "kpos" else src[name].select(lead, 0)
            d.select(lead, slot).copy_(s)

    def admit(pool, one, slot: int):
        for key, group in pool["blocks"].items():
            put(group, one["blocks"][key], slot, 1)
        for dst, src in zip(pool.get("tail", []), one.get("tail", [])):
            put(dst, src, slot, 0)
        return pool

    return admit


def init_slot_pool(cfg: ModelConfig, slots: int, cache_len: int, device="cuda"):
    """Empty pool caches, :func:`transformer.init_cache` with the slots as its
    batch and a position row per slot: kpos (n_super, slots, eff) in the
    blocks and (slots, eff) in the tail, = -1, so an un-admitted slot
    attends to nothing."""
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
    return pool
