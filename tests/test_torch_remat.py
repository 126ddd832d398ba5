"""Activation checkpointing (``ParallelConfig.remat``, the reference's
``jax.checkpoint`` of each super-block and each encoder layer) in the
port's train step.

With ``remat`` the loss runs each super-block of the ``blocks`` group,
FSDP's per-block gather included, and each encoder layer under
``torch.utils.checkpoint``; the recompute must change no bit.  Held here
on the CPU, f32 smoke widths, for llama (dense), mamba2 (ssm) and whisper
(encoder and cross-attention):
- a train step with remat on is bitwise the one with it off (losses, grad
  norms, params after 2 AdamW steps under alie), at model 1 and 2,
  replicated, and fsdp over the in-process workers and over a gloo
  process group of one rank (where the block gather runs in the forward);
- the robust aggregation calls a step (one B1 / B2 launch each on the
  card) are the same;
- autograd keeps fewer bytes for the backward with remat (counted by
  ``torch.autograd.graph.saved_tensors_hooks``), so a remat that does
  nothing fails;
- under the process group the robust reduce-scatter (the gather's
  backward) runs once a gathered leaf a step with remat on, as off, while
  the forward's gathers run again in the recompute.

Serial time: ~11 s on 2 threads (15 tests).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import distributed as D
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline
from repro_torch.kernels import robust_agg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, trainer
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_unflatten_like

torch.set_num_threads(2)

ARCHS = ("llama3.2-3b", "mamba2-2.7b", "whisper-small")
# (param_mode, model): the step's layouts that take the flag
LAYOUTS = (("replicated", 1), ("replicated", 2), ("fsdp", 1))


def _cfg(arch):
    return dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")


def _run(cfg, mesh, mode, remat, calls=None, method="median"):
    pcfg = ParallelConfig(agg_method=method, agg_strategy="gather", agg_beta=0.25,
                          param_mode=mode, remat=remat, attn_chunk=0)
    n = len(calls) if calls is not None else 0
    r = trainer.train_loop(cfg, pcfg, TrainConfig(optimizer="adamw", lr=1e-2, steps=2,
                                                  device_steps=1), mesh,
                           dcfg=pipeline.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4,
                                                    num_workers=mesh_lib.num_workers(mesh),
                                                    seed=0),
                           attack=AttackConfig("alie", 0.5))
    return r, (calls[n:] if calls is not None else None)


def _count_calls(monkeypatch):
    calls = []
    for name in ("median_many", "trimmed_mean_many"):
        real = getattr(robust_agg, name)

        def counted(xs, *args, _real=real, _name=name):
            calls.append((_name, len(xs)))
            return _real(xs, *args)

        monkeypatch.setattr(robust_agg, name, counted)
    return calls


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("mode,model", LAYOUTS, ids=[f"{m}-m{k}" for m, k in LAYOUTS])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_the_step_without_it(arch, mode, model, monkeypatch):
    """2 AdamW steps of gather median under alie alpha 0.5 over
    make_debug_mesh(2, model): with remat the losses, grad norms and
    params are bitwise those without, and the aggregation calls a step
    the same."""
    cfg = _cfg(arch)
    mesh = mesh_lib.make_debug_mesh(2, model, device="cpu")
    calls = _count_calls(monkeypatch)
    off, c_off = _run(cfg, mesh, mode, False, calls)
    on, c_on = _run(cfg, mesh, mode, True, calls)
    assert c_on == c_off and len(c_off) >= 2
    assert [h["loss"] for h in on.history] == [h["loss"] for h in off.history]
    assert [h["grad_norm"] for h in on.history] == [h["grad_norm"] for h in off.history]
    assert _bitwise(on.state["params"], off.state["params"])
    assert not _bitwise(on.state["params"], T.init_params(cfg, 0, "cpu"))


def _saved_bytes(cfg, remat):
    params = T.init_params(cfg, 0, "cpu")
    r = np.random.default_rng(1)
    batch = {k: torch.from_numpy(r.integers(0, cfg.vocab, (2, 16))) for k in ("tokens", "labels")}
    if cfg.frontend != "none":
        batch["frontend"] = torch.from_numpy(
            r.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = T.loss_fn(tree_unflatten_like(params, leaves), batch, cfg, kv_block=0,
                         remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return total[0], loss.detach(), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_fewer_bytes_for_the_backward(arch):
    """The bytes autograd saves while the loss runs (the checkpointed
    regions save only their inputs): fewer with remat, the loss and every
    gradient bitwise the same."""
    cfg = _cfg(arch)
    kept_off, loss_off, g_off = _saved_bytes(cfg, False)
    kept_on, loss_on, g_on = _saved_bytes(cfg, True)
    assert kept_on < kept_off, (kept_on, kept_off)
    assert torch.equal(loss_on, loss_off)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g_on, g_off))


def test_no_checkpoint_without_autograd():
    """Under ``torch.no_grad`` (prefill, decode, evaluation) remat changes
    nothing: the forward is the same bits either way."""
    cfg = _cfg("whisper-small")
    params = T.init_params(cfg, 0, "cpu")
    tok = torch.zeros((1, 8), dtype=torch.long)
    fe = torch.ones((1, cfg.n_frontend_tokens, cfg.d_model))
    with torch.no_grad():
        a, _ = T.forward(params, tok, cfg, frontend=fe, remat=True)
        b, _ = T.forward(params, tok, cfg, frontend=fe, remat=False)
    assert torch.equal(a, b)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of one rank in this process (destroyed after)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        yield mesh_lib.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "whisper-small"])
def test_fsdp_reduce_scatter_runs_once_a_leaf_a_step(arch, one_rank_group, monkeypatch):
    """fsdp under a process group (one rank: its shards are the whole
    leaves, gathered in the forward by the block provider inside the
    checkpoint): the robust reduce-scatter runs once a gathered leaf a
    step with remat on, as with it off, while the forward's gathers of the
    ``blocks`` leaves run twice (the recompute); the steps are bitwise the
    same."""
    mesh = one_rank_group
    assert mesh.per_rank and mesh_lib.num_workers(mesh) == 1
    cfg = _cfg(arch)
    counts = {"scatter": 0, "gather": 0}
    real_rs, real_fwd = D.robust_reduce_scatter_dims, D._RobustParamGather.forward

    def scatter(*args, **kwargs):
        counts["scatter"] += 1
        return real_rs(*args, **kwargs)

    def gather(ctx, *args):
        counts["gather"] += 1
        return real_fwd(ctx, *args)

    monkeypatch.setattr(D, "robust_reduce_scatter_dims", scatter)
    monkeypatch.setattr(D._RobustParamGather, "forward", staticmethod(gather))
    out = {}
    for remat in (False, True):
        counts.update(scatter=0, gather=0)
        r, _ = _run(cfg, mesh, "fsdp", remat)
        out[remat] = (r, dict(counts))
    (off, c_off), (on, c_on) = out[False], out[True]
    dims = steps.fsdp_dims(cfg, mesh)
    n_super = T.layer_groups(cfg)[0][0][1]
    blocks = sum(d >= 0 for g in dims["blocks"].values() for d in g.values()) * n_super
    assert c_on["scatter"] == c_off["scatter"] > 0
    if arch == "llama3.2-3b":  # every gathered piece is read: one scatter each a step
        rest = sum(d >= 0 for k, g in dims.items() if k != "blocks"
                   for d in (g.values() if isinstance(g, dict) else [g]))
        assert c_off["scatter"] == 2 * (blocks + rest), (c_off, blocks, rest)
    assert c_on["gather"] - c_off["gather"] == 2 * blocks  # 2 steps, each block recomputed
    assert [h["loss"] for h in on.history] == [h["loss"] for h in off.history]
    assert _bitwise(on.state["params"], off.state["params"])
