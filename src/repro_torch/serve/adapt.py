"""Robust continual fine-tuning from served feedback (the reference's
``repro.serve.adapt``).

Every cadence window the adapter drains one fixed-shape batch of completed
traffic per gradient shard (``traffic.build_round``) and runs ONE
:mod:`repro_torch.rounds.engine` round over the model parameters:

    feedback shards -> score-weighted local LM gradients, (m, D) f32 rows
    -> optional wire codec (rounds.compression)
    -> optional gradient-space attack (attacks/engine.apply_to_rows;
       feedback attacks already corrupted the scores upstream)
    -> robust aggregation (core.aggregators: on the card the median and
       the trimmed mean are ONE launch of the B1 / B2 kernel over all D
       coordinates)
    -> optimizer update (repro_torch.optim)

The rows are written shard by shard into one (m, D) float32 buffer that
the round function allocates once and reuses: no stack of m gradient
trees and no second copy of the rows (at llama3.2-3b's width with 8
layers and m = 4 the rows alone are 25.5 GB).

State is the engine's :data:`RoundState`; after each round it can be
snapshotted (``rounds.engine.save_snapshot``, atomic LATEST) and the fresh
iterate is hot-swapped into the running
:class:`~repro_torch.serve.engine.ServeEngine`.  Restarting from the
snapshot and replaying the remaining traffic reproduces the uninterrupted
run bit for bit.

:func:`weighted_nll` normalizes by ``sum(|w|)`` rather than
``layers.cross_entropy``'s ``sum(mask)``: negative feedback scores would
otherwise flip the loss's sign *and* its scale.

On a mesh with a model axis (tensor parallelism) the per-shard gradients
run through the model-axis forward.  On the in-process mesh the iterate,
the rows and the aggregate are the global ones (the rows are model 1's
function, computed on the model shards; the aggregation is model 1's
call).  Under a process group a rank holds its shards of the iterate
(:class:`~repro_torch.serve.engine.ModelShards`) and writes its own
columns of the rows, (m, D_rank) in the ravel order of its leaves; its
B1 / B2 launch aggregates those columns, which is bitwise its columns of
one launch over the whole rows (the median and the trimmed mean are
coordinate-wise); the update runs on its shards and the round's norm
psums the split columns' squares over the model axis.  A leaf the layers
gather (the ``ssm`` / ``rec`` in-projections, attention in ``gathered``
mode) is split all the same: a rank's columns of it are its chunk of the
whole gradient, in its ravel order.  Snapshots hold the
global state, gathered over the model axis and written by global rank 0;
a restore cuts each rank's shards, so a snapshot restores at any model
size.  The codecs and randomized gradient attacks act on whole rows, as
at model 1: a rank gathers its columns over the model axis into the
global (m, D) rows, compresses them (the error-feedback residual is the
global (m, D) on every rank alike) and keeps its columns; a randomized
payload is drawn over the global rows and cut to the rank's columns.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch import rng
from repro_torch.attacks import base as atk_base
from repro_torch.attacks import engine as atk_engine
from repro_torch.configs.base import ModelConfig
from repro_torch.core import aggregators
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.rounds import compression as comp_lib
from repro_torch.rounds import engine as rounds_engine
from repro_torch.serve.engine import ModelShards, refuse_frontend
from repro_torch.tree import tree_leaves, tree_unflatten_like

_COMP_KEY = 11  # the repo-wide compression key base


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """One continual-adaptation round's configuration."""

    method: str = "median"  # robust aggregator (core.aggregators)
    beta: float = 0.2  # trimmed-mean fraction / aggregator knob
    optimizer: str = "sgd"
    lr: float = 0.1
    compression: str = "none"  # wire codec on the (m, D) gradient rows
    batch_per_shard: int = 2  # B: completions per shard per round
    adapt_every: int = 32  # cadence, in engine ticks
    grad_attack: Optional[str] = None  # extra gradient-space attack
    grad_alpha: float = 0.0  # Byzantine fraction for grad_attack
    seed: int = 0

    def __post_init__(self):
        aggregators.get_aggregator(self.method, self.beta)  # validates
        comp_lib.get_compression(self.compression)
        if self.batch_per_shard < 1:
            raise ValueError("batch_per_shard must be >= 1")
        if self.adapt_every < 1:
            raise ValueError("adapt_every must be >= 1")
        if self.grad_attack is not None:
            spec = atk_engine.as_attack(self.grad_attack)
            if spec.access in (atk_base.DATA, atk_base.FEEDBACK):
                raise ValueError(
                    f"grad_attack {spec.name!r} is {spec.access}-access; "
                    "feedback corruption is configured on TrafficConfig")


def weighted_nll(params, cfg: ModelConfig, tokens, labels, weights,
                 ctx: sharding.ShardCtx = sharding.NULL_CTX) -> torch.Tensor:
    """Score-weighted next-token NLL over one shard's (B, L) batch;
    ``weights`` carry the feedback score on response positions (zero on
    prompt and padding).  Under a model axis (``ctx``) the forward runs on
    the model shards and its logits are whole on every rank.  Nothing is
    checkpointed, as in the reference's adapter (``remat=False``)."""
    logits, _aux = T.forward(params, tokens, cfg, kv_block=0, ctx=ctx, remat=False)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    denom = torch.clamp(torch.sum(torch.abs(weights)), min=1.0)
    return torch.sum(nll * weights) / denom


def num_coordinates(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _grad_pieces(params):
    """``(tree, pieces)``: ``params`` with every stacked block leaf given as
    its per-layer views (``unbind(0)``), each view and every other leaf (the
    tail's included) a detached tensor requiring grad; ``pieces`` in ravel
    order, where a stacked leaf's coordinates are its layers' one after the
    other."""
    pieces = []

    def req(t):
        t = t.detach().requires_grad_(True)
        pieces.append(t)
        return t

    tree = {}
    for key, v in params.items():  # insertion order is ravel order
        if key == "blocks":
            tree[key] = {g: {k: tuple(req(x) for x in t.detach().unbind(0))
                             for k, t in group.items()} for g, group in v.items()}
        elif key == "tail":
            tree[key] = [{k: req(t) for k, t in layer.items()} for layer in v]
        else:
            tree[key] = req(v)
    return tree, pieces


def feedback_grad_rows(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                       out: Optional[torch.Tensor] = None,
                       ctx: sharding.ShardCtx = sharding.NULL_CTX) -> torch.Tensor:
    """Per-shard raveled gradients as (m, D) float32 rows — the transmitted
    payload of one adaptation round — written shard by shard into ``out``
    (allocated when None), coordinates in ravel order.  Under a model axis
    (``ctx``) ``params`` are the tree this process holds (the global view
    in process, a rank's shards under a process group, whose rows are then
    its (m, D_rank) columns)."""
    d = num_coordinates(params)
    m = batch["tokens"].shape[0]
    if out is None:
        out = torch.empty((m, d), dtype=torch.float32, device=tree_leaves(params)[0].device)
    elif tuple(out.shape) != (m, d) or out.dtype != torch.float32:
        raise ValueError(f"rows buffer {tuple(out.shape)} {out.dtype}, want {(m, d)} float32")
    for s in range(m):
        tree, pieces = _grad_pieces(params)
        loss = weighted_nll(tree, cfg, batch["tokens"][s], batch["labels"][s],
                            batch["weights"][s], ctx)
        grads = torch.autograd.grad(loss, pieces, allow_unused=True)
        off = 0
        for g, p in zip(grads, pieces):
            dst = out[s, off:off + p.numel()]
            if g is None:
                dst.zero_()
            else:
                dst.copy_(g.reshape(-1))
            off += p.numel()
        del grads, loss
    return out


def make_feedback_stages(cfg: ModelConfig, acfg: AdaptConfig, batch: Dict[str, torch.Tensor],
                         opt, rows: Optional[torch.Tensor] = None,
                         ctx: sharding.ShardCtx = sharding.NULL_CTX,
                         shards: Optional[ModelShards] = None) -> rounds_engine.RoundStages:
    """The round engine's stage pipeline of one adaptation round over
    ``batch`` (on the parameters' device), the gradients written into
    ``rows`` when given; ``ctx`` the model axis the gradients run over and
    ``shards`` how the iterate is held on it (a process group's rank:
    its norm and a leaf-global attack's sums completed over the axis)."""
    agg = aggregators.get_aggregator(acfg.method, acfg.beta)
    spec = comp_lib.get_compression(acfg.compression)
    m = batch["tokens"].shape[0]
    per_rank = shards is not None and shards.per_rank

    def local_work(w, r):
        return feedback_grad_rows(w, cfg, batch, out=rows, ctx=ctx)

    compress = None
    if acfg.compression != "none":
        def compress(payload, res, r):
            gen = (rng.generator(_COMP_KEY, r, device=payload.device)
                   if (spec.randomized or spec.shared_key) else None)
            # the message is the whole row: a rank's columns gathered first
            out, new_res = comp_lib.compress_rows(
                acfg.compression, shards.gather_flat(payload) if per_rank else payload,
                generator=gen, residual=res if spec.error_feedback else None)
            if per_rank:
                out = shards.cut_flat(out)
            return out, (new_res if spec.error_feedback else res)

    attack = None
    if acfg.grad_attack is not None and acfg.grad_alpha > 0:
        whole = None
        if per_rank and atk_engine.as_attack(acfg.grad_attack).randomized:
            whole = ((m, shards.size), shards.cut_flat)  # drawn over the global rows

        def attack(payload, prev_agg, r):
            mask = atk_engine.byzantine_mask(acfg.grad_alpha, m, device=payload.device)
            gen = rng.generator(acfg.seed, r, device=payload.device)
            return atk_engine.apply_to_rows(
                acfg.grad_attack, payload, mask, alpha=acfg.grad_alpha,
                generator=gen, prev_agg=prev_agg, rnd=r,
                row_sum=shards.row_sum if per_rank else None, whole=whole)

    def aggregate(payload):
        return agg(payload.float())

    def update(w, opt_state, agg_vec, r):
        leaves = tree_leaves(w)
        parts = torch.split(agg_vec, [t.numel() for t in leaves])
        # each rebuilt leaf in its parameter's dtype: the hot-swapped
        # iterate keeps the served tensors' shapes and dtypes
        grads = tree_unflatten_like(w, [p.reshape(t.shape).to(t.dtype)
                                        for p, t in zip(parts, leaves)])
        return opt.update(grads, opt_state, w, r)

    def emit(w_new, agg_vec):
        if per_rank:
            return shards.norm(agg_vec)
        return torch.linalg.vector_norm(agg_vec.float())

    return rounds_engine.RoundStages(
        local_work=local_work, aggregate=aggregate, update=update,
        compress=compress, attack=attack, emit=emit)


class RoundFn:
    """``round_fn(state, batch) -> (state, grad_norm)``: one round-engine
    round over ``batch`` (moved to the iterate's device).  It owns the
    (m, D) rows buffer, allocated at the first round and reused after
    (under a process group with a model axis the rank's (m, D_rank))."""

    def __init__(self, cfg: ModelConfig, acfg: AdaptConfig, mesh=None):
        refuse_frontend(cfg)
        self.cfg = cfg
        self.acfg = acfg
        self.opt = get_optimizer(acfg.optimizer, acfg.lr)
        self.ctx = sharding.model_ctx(mesh) if mesh is not None else sharding.NULL_CTX
        self.shards = ModelShards(cfg, mesh)
        self.rows: Optional[torch.Tensor] = None

    def stages(self, state: rounds_engine.RoundState, batch) -> rounds_engine.RoundStages:
        w = state["w"]
        dev = tree_leaves(w)[0].device
        batch = {k: batch[k].to(dev) for k in ("tokens", "labels", "weights")}
        shape = (batch["tokens"].shape[0], num_coordinates(w))
        if self.rows is None or tuple(self.rows.shape) != shape or self.rows.device != dev:
            self.rows = None  # the old buffer goes before the new one comes
            self.rows = torch.empty(shape, dtype=torch.float32, device=dev)
        return make_feedback_stages(self.cfg, self.acfg, batch, self.opt, rows=self.rows,
                                    ctx=self.ctx, shards=self.shards)

    def __call__(self, state: rounds_engine.RoundState, batch):
        body = rounds_engine.make_round_body(self.stages(state, batch))
        return body(state, int(state["round"]))


def make_round_fn(cfg: ModelConfig, acfg: AdaptConfig, mesh=None) -> RoundFn:
    return RoundFn(cfg, acfg, mesh)


def init_adapt_state(params, acfg: AdaptConfig, num_shards: int,
                     width: Optional[int] = None) -> rounds_engine.RoundState:
    """Fresh RoundState over the model parameters (the tree this process
    holds: a rank's shards under a process group with a model axis): a
    flat float32 previous aggregate (the wire is (m, D) rows), per-shard
    residuals for error-feedback codecs (``width`` columns, default the
    tree's: a rank's residual is the global rows'), optimizer state from
    repro_torch.optim."""
    opt = get_optimizer(acfg.optimizer, acfg.lr)
    d = num_coordinates(params)
    dev = tree_leaves(params)[0].device
    comp_res = (torch.zeros((num_shards, width or d), dtype=torch.float32, device=dev)
                if comp_lib.get_compression(acfg.compression).error_feedback else ())
    return rounds_engine.make_state(
        params, prev_agg=torch.zeros((d,), dtype=torch.float32, device=dev),
        comp_res=comp_res, opt_state=opt.init(params), seed=acfg.seed)


class FeedbackAdapter:
    """Buffers served traffic per shard and fires robust rounds on cadence.

    Duck-typed for :func:`repro_torch.serve.engine.serve_stream`:
    ``offer(Completed)`` banks a completion into its shard's buffer;
    ``maybe_round(engine)`` fires when (a) at least ``adapt_every`` ticks
    passed since the last round and (b) EVERY shard holds a full batch —
    then builds the round batch, runs the round, snapshots the RoundState
    (with ``ckpt_dir``) and hot-swaps the fresh iterate into the engine.
    """

    def __init__(self, cfg: ModelConfig, acfg: AdaptConfig, users, params,
                 ckpt_dir: Optional[str] = None, mesh=None):
        self.cfg = cfg
        self.acfg = acfg
        self.users = users
        self.ckpt_dir = ckpt_dir
        m = users.cfg.num_shards
        self.buffers: List[List[Any]] = [[] for _ in range(m)]
        self.round_fn = make_round_fn(cfg, acfg, mesh)
        self.shards = self.round_fn.shards
        held = self.shards.cut(params) if self.shards.per_rank else params
        self.state = init_adapt_state(held, acfg, m,
                                      self.shards.size if self.shards.per_rank else None)
        self._last_round_tick = 0
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------ buffers

    def offer(self, done):
        self.buffers[done.request.shard].append(done)

    def ready(self) -> bool:
        B = self.acfg.batch_per_shard
        return all(len(b) >= B for b in self.buffers)

    def _drain(self) -> List[List[Any]]:
        B = self.acfg.batch_per_shard
        window = [b[:B] for b in self.buffers]
        self.buffers = [b[B:] for b in self.buffers]
        return window

    # ------------------------------------------------------------- rounds

    @property
    def rounds_done(self) -> int:
        return int(self.state["round"])

    def run_round(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One robust adaptation round over a prebuilt batch; returns the
        history entry (also the offline-equivalence tests' entry point)."""
        rnd = self.rounds_done
        self.state, grad_norm = self.round_fn(self.state, batch)
        entry = {
            "round": rnd,
            "grad_norm": float(grad_norm),
            "score_mean": float(torch.mean(batch["scores"])),
            "score_honest_mean": float(torch.mean(batch["scores_honest"])),
        }
        self.history.append(entry)
        if self.ckpt_dir:
            rounds_engine.save_snapshot(self.ckpt_dir, self.state, layout=self.shards)
        return entry

    def restore(self, ckpt_dir: str, rnd: Optional[int] = None) -> None:
        """Resume from the snapshot at round ``rnd`` (default: the latest),
        written at any model size: this rank's part of its global state."""
        self.state, _host = rounds_engine.load_snapshot(ckpt_dir, self.state, rnd,
                                                        layout=self.shards)

    def global_iterate(self):
        """The global iterate (a collective under a process group with a
        model axis)."""
        return self.shards.gather(self.state["w"])

    def maybe_round(self, engine) -> Optional[Dict[str, float]]:
        if engine.tick - self._last_round_tick < self.acfg.adapt_every:
            return None
        if not self.ready():
            return None
        batch = self.users.build_round(self._drain(), self.rounds_done)
        entry = self.run_round(batch)
        self._last_round_tick = engine.tick
        entry["tick"] = engine.tick
        entry["params_version"] = engine.swap_params(self.state["w"])
        return entry
