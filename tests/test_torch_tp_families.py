"""Tensor parallelism of the ``ssm`` / ``rec`` layers, the whisper encoder
and its cross-attention, and the vision prefix (a mesh's ``model`` axis >
1), against the port's own model-1 run.

The reference's model-axis forward does not run in this jax (its
embedding gather raises ``ShardingTypeError`` once the params carry
model-axis shardings), so tests/test_torch_tp.py holds these families at
model 2 and 4 against the reference at model 1 (``FORWARD``) and on 4 gloo
ranks (``RANK_CELLS``), and tests/test_torch_tp_serve.py holds mamba2 and
recurrentgemma's prefill, decode and engine tokens there.  This file
holds them against the port's model 1: the forward, the loss and every
gradient leaf, the serving caches (the recurrent states split on heads
and channels; tests/test_torch_mixer_tp.py holds the split mixers across
processes), and one train step per family at (data 2, model 2) with the
same aggregation calls.  Smoke widths, float32.

Tolerances, stated where used:
- logits and loss against model 1: 1e-5 absolute (tests/test_torch_tp.py's
  ``FWD_TOL``); gradients 1e-5 times max(1, the leaf's largest model-1
  gradient); caches 1e-5 absolute;
- the train step at (2, 2) against (2, 1), 2 SGD steps of 0.5: losses and
  grad norms 1e-6 relative, params 1e-5 absolute (tests/test_torch_tp.py's
  ``LOSS_RTOL`` / ``PARAM_ATOL``); the robust aggregation calls (one B1 /
  B2 launch each on the card) equal in number and in leaves.

Serial time: ~10 s on 2 threads (14 tests).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline
from repro_torch.kernels import robust_agg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, trainer
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten_like

torch.set_num_threads(2)

FWD_TOL = 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
FAMILIES = ("mamba2-2.7b", "recurrentgemma-2b", "whisper-small", "internvl2-1b")
CASES = [(a, m) for a in FAMILIES for m in (2, 4)]


def _cfg(arch, **over):
    return dataclasses.replace(configs.get_smoke_config(arch), dtype="float32", **over)


def _ctx(model):
    return sharding.model_ctx(mesh_lib.make_debug_mesh(1, model, device="cpu"))


def _batch(cfg, b=2, s=12, seed=7):
    r = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(r.integers(0, cfg.vocab, (b, s))) for k in ("tokens", "labels")}
    if cfg.frontend != "none":
        batch["frontend"] = torch.from_numpy(
            r.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _loss_and_grads(params, batch, cfg, ctx):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = T.loss_fn(tree_unflatten_like(params, leaves), batch, cfg, kv_block=0, ctx=ctx)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]


@pytest.mark.parametrize("arch,model", CASES, ids=[f"{a}-m{m}" for a, m in CASES])
def test_forward_and_gradients_match_the_port_s_model_one(arch, model):
    """Model M in process (each layer's ranks in turn on the global view)
    against the port's model 1 on the same params and batch: logits, loss
    and every gradient leaf (whisper's unread cross FFN leaves exactly 0
    at both); the modes are the ones the rules give."""
    cfg = _cfg(arch)
    params = T.init_params(cfg, 0, "cpu")
    batch = _batch(cfg)
    ctx = _ctx(model)
    modes = ctx.modes(cfg)
    if cfg.ssm is not None:
        assert modes.mixer_out == ("w_out",) and modes.ssm == "heads"
    if arch == "recurrentgemma-2b":
        assert modes.mixer_in == ("w_a", "w_bg", "w_bx", "w_xg") and modes.mixer_out == ("w_ro",)
        assert modes.rec == "channels"
    with torch.no_grad():
        want, _ = T.forward(params, batch["tokens"], cfg, frontend=batch.get("frontend"),
                            kv_block=0)
        got, _ = T.forward(params, batch["tokens"], cfg, frontend=batch.get("frontend"),
                           kv_block=0, ctx=ctx)
    torch.testing.assert_close(got, want, atol=FWD_TOL, rtol=0)
    l1, g1 = _loss_and_grads(params, batch, cfg, sharding.NULL_CTX)
    lm, gm = _loss_and_grads(params, batch, cfg, ctx)
    assert abs(float(lm) - float(l1)) <= FWD_TOL
    for (path, _), a, b in zip(tree_leaves_with_path(params), gm, g1):
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, atol=FWD_TOL * scale, rtol=0, msg=path)
        if path.startswith("cross_blocks/") and path.split("/")[-1] in ("wg", "wu", "wd", "ln2"):
            assert not a.any() and not b.any(), path


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_recurrent_states_are_whole_on_every_rank(arch):
    """The recurrent states split over the model axis as the reference's
    specs split them (the name is the test's from before the split; it
    pins the new layout).  The prefill cache at (1, 2), the global view of
    the ranks' states, is model 1's (within 1e-5), and so is it after a
    decode step at model 2; ``cache_dims`` splits ``ssd`` on its heads and
    ``rec``'s ``conv`` and ``h`` on channels, and holds the ``ssm`` conv
    window as a HeadsConv (a rank's x channels, B and C whole); a rank's
    slot pool under a process group holds whole/model of ``ssd``, ``h`` and
    ``rec``'s ``conv``, and di/model + 2n channels of the ``ssm`` window."""
    cfg = _cfg(arch)
    params = T.init_params(cfg, 0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        l1, c1 = T.prefill(params, tokens, cfg, cache_len=12)
        l2, c2 = T.prefill(params, tokens, cfg, cache_len=12, ctx=_ctx(2))
        torch.testing.assert_close(l2, l1, atol=FWD_TOL, rtol=0)
        for (path, a), b in zip(tree_leaves_with_path(c2), tree_leaves(c1)):
            torch.testing.assert_close(a, b, atol=FWD_TOL, rtol=0, msg=path)
        tok = torch.argmax(l1[:, -1], -1, keepdim=True)
        d1, c1 = T.decode_step(params, tok, c1, 8, cfg)
        d2, c2 = T.decode_step(params, tok, c2, 8, cfg, _ctx(2))
        torch.testing.assert_close(d2, d1, atol=FWD_TOL, rtol=0)
        for (path, a), b in zip(tree_leaves_with_path(c2), tree_leaves(c1)):
            torch.testing.assert_close(a, b, atol=FWD_TOL, rtol=0, msg=path)
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    dims = dict(tree_leaves_with_path(sharding.cache_dims(cfg, 2, c2,
                                                          steps.cache_shardings(cfg, mesh, c2))))
    recurrent = [p for p in dims if p.split("/")[-1] in ("conv", "ssd", "h")]
    assert recurrent
    per_rank = mesh_lib.Mesh(("data", "model"), (2, 2), torch.device("cpu"), None, rank=1,
                             per_rank=True)
    pool = dict(tree_leaves_with_path(steps.init_slot_pool(cfg, 3, 12, "cpu", mesh=per_rank)))
    whole = dict(tree_leaves_with_path(steps.init_slot_pool(cfg, 3, 12, "cpu")))
    for p in recurrent:
        d = dims[p]
        if isinstance(d, sharding.HeadsConv):
            s_cfg, di = T._ssm_dims(cfg)[:2]
            assert d.di == di and pool[p].shape[d.dim] == di // 2 + 2 * s_cfg.d_state, p
            continue
        assert d == pool[p].dim() - (3 if p.endswith("ssd") else 1), p
        assert pool[p].numel() * 2 == whole[p].numel() and pool[p].shape[d] * 2 \
            == whole[p].shape[d], p


def _count_calls(monkeypatch):
    """Each ``robust_agg.median_many`` / ``trimmed_mean_many`` call (one B1
    / B2 launch on the card) with its leaf count."""
    calls = []
    for name in ("median_many", "trimmed_mean_many"):
        real = getattr(robust_agg, name)

        def counted(xs, *args, _real=real, _name=name):
            calls.append((_name, len(xs)))
            return _real(xs, *args)

        monkeypatch.setattr(robust_agg, name, counted)
    return calls


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_train_step_at_data_two_model_two(arch, monkeypatch):
    """2 SGD steps of gather median under alie alpha 0.5 through
    ``trainer.train_loop`` at (2, 2) against (2, 1) from the same params
    and batches: losses and grad norms within 1e-6 relative, params within
    1e-5, and the same aggregation calls (one B1 call a step, over every
    leaf; at m = 2 no trim of the trimmed mean reaches B2)."""
    cfg = _cfg(arch)
    method = "median"
    pcfg = ParallelConfig(agg_method=method, agg_strategy="gather", agg_beta=0.25,
                          attn_chunk=0)
    calls = _count_calls(monkeypatch)
    out = {}
    for model in (1, 2):
        n = len(calls)
        r = trainer.train_loop(cfg, pcfg, trainer.TrainConfig(optimizer="sgd", lr=0.5, steps=2,
                                                              device_steps=1),
                               mesh_lib.make_debug_mesh(2, model, device="cpu"),
                               dcfg=pipeline.DataConfig(vocab=cfg.vocab, seq_len=16,
                                                        global_batch=4, num_workers=2, seed=0),
                               attack=AttackConfig("alie", 0.5))
        out[model] = (r, calls[n:])
    (r1, c1), (r2, c2) = out[1], out[2]
    n_leaves = len(tree_leaves(r1.state["params"]))
    assert c1 == c2 == [(f"{method}_many", n_leaves)] * 2
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in r2.history], [h[key] for h in r1.history],
                                   rtol=LOSS_RTOL)
    for (path, a), b in zip(tree_leaves_with_path(r2.state["params"]),
                            tree_leaves(r1.state["params"])):
        torch.testing.assert_close(a, b, atol=PARAM_ATOL, rtol=0, msg=path)
    init = T.init_params(cfg, 0, "cpu")
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(r2.state["params"]),
                                                     tree_leaves(init)))
