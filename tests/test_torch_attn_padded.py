"""Attention split over each rank's kv-head group where the kv heads do not
divide the model size (``sharding.TPModes.attn`` ``padded``), as the
reference's ``ShardCtx._ok`` splits them unevenly (GSPMD pads) when
``2·kv >= M``: rank r attends with kv heads ``sharding.kv_heads(kv, M, r)``
(ceil(kv / M) a rank, the last ranks fewer or none) and their query
groups; the leaves keep their even chunks, one all-to-all hands each rank
its heads' q, k and v columns and another the attention output's columns
of its ``wo`` rows; the serving caches hold each rank's kv heads (zero
wide on a rank with none).

The reference's model-axis forward does not run in this jax (ROADMAP C),
so the split attention is held against the port's model 1 and against
the reference at model 1 (its functions unsharded, the params carried
over with ``convert.transformer_from_reference``), in process (each
layer's model ranks in turn on the global view), and across processes:
4 gloo ranks at (data 1, model 4) with 3 kv heads (rank 3 holds none) and
at (data 2, model 2) with one kv head (qwen3's qk-norm; model rank 1 holds
none), spawned once for the module and run while the in-process tests do.

Tolerances, stated where used (float32, smoke widths):
- in process at model 2 and 4 against model 1, and the port against the
  reference at model 1: loss and logits 1e-5 absolute (FWD_TOL, magnitudes
  below 10), gradients 1e-5 times max(1, the leaf's largest model-1
  gradient), caches 1e-5 absolute;
- seq_parallel at (2, 2) against (2, 1), 1 SGD step of 0.5: loss and grad
  norm 1e-6 relative, params 1e-5 absolute (LOSS_RTOL / PARAM_ATOL);
- the gloo ranks against the in-process runs: bitwise (the all-to-alls
  move bits as they are; a sum of partials is taken in rank order).

Serial time: ~40 s on 2 threads (the gloo ranks run beside the in-process
tests).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import transformer as RT
from repro.models.sharding import ShardCtx as RefShardCtx
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import distributed as D
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, trainer
from repro_torch.models import convert, sharding
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ModelShards
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten_like

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
FWD_TOL = 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
ATTN = ("wq", "wk", "wv", "wo")
# the configurations: (registry name, overrides), float32
CFGS = {
    "kv3": ("llama3.2-3b", dict(n_heads=6, n_kv_heads=3)),  # groups straddle model-2 chunks
    "kv1": ("qwen3-14b", {}),  # one kv head, five query heads, qk-norm
    "window": ("h2o-danube-1.8b", {}),  # 2 kv heads, sliding window 16
    # 80 frames: the encoder's 160 tokens outnumber d_model 128
    "whisper": ("whisper-small", dict(n_heads=6, n_kv_heads=3, head_dim=32,
                                      n_frontend_tokens=80)),
}
# the in-process cells: (configuration, model size, sequence length).  The
# loss and the prefill of 2 rows move the weights' columns where 2·S
# outnumbers d_model (kv3 192, kv1 160, window and whisper 128), the
# products' below; decode (2 tokens) always moves the products
CASES = [("kv3", 2, 12), ("kv3", 4, 112), ("kv1", 2, 96), ("window", 4, 24),
         ("window", 4, 80), ("whisper", 2, 72), ("whisper", 4, 12)]
# the gloo jobs: name -> (configuration, model size of make_production_mesh,
# the train step's sequence length: its tokens a worker outnumber d_model,
# so the step moves the weights' columns, the serving steps the products')
RANK_JOBS = {"kv3_1x4": ("kv3", 4, 64), "kv1_2x2": ("kv1", 2, 96)}
SERVE = dict(batch=4, prompt=8, cache_len=12, decodes=2)

RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_attn_padded as T
T.run_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
"""


def _cfg(name):
    arch, over = CFGS[name]
    return dataclasses.replace(configs.get_smoke_config(arch), dtype="float32", **over)


def _ref_cfg(name):
    arch, over = CFGS[name]
    return dataclasses.replace(ref_get_smoke_config(arch), dtype="float32", **over)


def _ctx(model, data=1):
    return sharding.model_ctx(mesh_lib.make_debug_mesh(data, model, device="cpu"))


def _inputs(cfg, b=2, s=12, seed=3):
    """Tokens, labels and (whisper) the frame embeddings, from numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    fe = None
    if cfg.frontend == "audio":
        fe = rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return tok, lab, fe


def _pbatch(tok, lab, fe):
    out = {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long()}
    if fe is not None:
        out["frontend"] = torch.from_numpy(fe)
    return out


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                         b.view(np.uint8))


@functools.lru_cache(maxsize=None)
def _models(name):
    """The reference's params (PRNGKey 0) and the port's copy of them."""
    rc = _ref_cfg(name)
    rp = RT.init_params(rc, jax.random.PRNGKey(0))
    return rp, convert.transformer_from_reference(_cfg(name), jax.tree.map(np.asarray, rp),
                                                  device="cpu")


def _port_run(name, s, ctx):
    """The loss and every gradient, the prefill's logits, two decode steps'
    logits and the cache after them, at ``ctx``, on 2 rows of ``s``
    tokens."""
    cfg = _cfg(name)
    _, params = _models(name)
    tok, lab, fe = _inputs(cfg, s=s)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = T.loss_fn(tree_unflatten_like(params, leaves), _pbatch(tok, lab, fe), cfg,
                     kv_block=0, ctx=ctx, remat=False)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    with torch.no_grad():
        frontend = None if fe is None else torch.from_numpy(fe)
        logits, cache = T.prefill(params, torch.from_numpy(tok).long(), cfg, frontend=frontend,
                                  kv_block=0, cache_len=s + 2, ctx=ctx)
        out = [logits]
        for j in range(2):
            logits, cache = T.decode_step(params, torch.from_numpy(lab[:, j:j + 1]).long(),
                                          cache, s + j, cfg, ctx=ctx)
            out.append(logits)
    return float(loss.detach()), grads, [o.numpy() for o in out], cache


@functools.lru_cache(maxsize=None)
def _port_one(name, s):
    return _port_run(name, s, sharding.NULL_CTX)


@functools.lru_cache(maxsize=None)
def _ref_one(name, s):
    """The reference at model 1: its loss and gradients (carried to the
    port's tree), its prefill and decode logits on the same inputs."""
    rc, cfg = _ref_cfg(name), _cfg(name)
    rp, _ = _models(name)
    tok, lab, fe = _inputs(cfg, s=s)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    kw = {}
    if fe is not None:
        batch["frontend"] = kw["frontend"] = jnp.asarray(fe)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, b, rc, remat=False, kv_block=0)))(rp, batch)
    grads = convert.transformer_from_reference(cfg, jax.tree.map(np.asarray, grads),
                                               device="cpu")
    logits, cache = jax.jit(lambda p, t, **k: RT.prefill(p, t, rc, kv_block=0, cache_len=s + 2,
                                                         **k))(rp, jnp.asarray(tok), **kw)
    out = [np.asarray(logits)]
    decode = jax.jit(lambda p, t, c, pos: RT.decode_step(p, t, c, pos, rc))
    for j in range(2):
        logits, cache = decode(rp, jnp.asarray(lab[:, j:j + 1]), cache, jnp.int32(s + j))
        out.append(np.asarray(logits))
    return float(loss), tree_leaves(grads), out


def _close_grads(got, want, params, what):
    for (path, _), a, b in zip(tree_leaves_with_path(params), got, want):
        torch.testing.assert_close(a, b, atol=FWD_TOL * max(1.0, float(b.abs().max())), rtol=0,
                                   msg=f"{what}: {path}")


# ---------------------------------------------------------------------------
# (a) the plan: the reference's rule, the leaves on their shards, the caches
# ---------------------------------------------------------------------------

REGISTRY = [(a, s) for a in configs.ARCHITECTURES for s in ("full", "smoke")]


@pytest.mark.parametrize("model", [2, 4, 8, 16])
@pytest.mark.parametrize("arch,size", REGISTRY, ids=[f"{a}-{s}" for a, s in REGISTRY])
def test_mode_is_the_reference_ok_rule(arch, size, model):
    """``tp_modes(cfg, M).attn`` for every registry config (and its
    encoder's) at M = 2, 4, 8, 16: ``heads`` where the kv heads divide M,
    else ``padded`` where the reference's own ``ShardCtx._ok`` splits the
    kv dim (``2·kv >= M``), else ``gathered``; ``tp_plan`` lists no
    attention leaf as gathered outside ``gathered`` mode."""
    cfg = configs.get_config(arch) if size == "full" else configs.get_smoke_config(arch)
    rcfg = ref_get_config(arch) if size == "full" else ref_get_smoke_config(arch)
    kv = rcfg.n_kv_heads
    ok = RefShardCtx(mesh_shape={"model": model})._ok(kv, ("model",))
    want = "heads" if kv % model == 0 else "padded" if ok else "gathered"
    modes = sharding.tp_modes(cfg, model)
    assert len(modes.attn_split) == 4 and modes.attn == want, (modes.attn, want)
    assert sharding.tp_modes(T._enc_cfg(cfg), model).attn == want
    plan = sharding.tp_plan(cfg, model)
    attn = {p: m for p, (_, m) in plan.items() if p.split("/")[-1] in ATTN}
    has_attn = any(w.kind == "attn" for w in T.layer_slots(cfg))
    assert not has_attn or attn
    assert all(m == ("gathered" if want == "gathered" else "shard") for m in attn.values())


@pytest.mark.parametrize("kv,model,want", [
    (8, 16, [(k, k + 1) if k < 8 else (8, 8) for k in range(16)]),
    (12, 16, [(k, k + 1) if k < 12 else (12, 12) for k in range(16)]),
    (12, 8, [(2 * k, 2 * k + 2) if k < 6 else (12, 12) for k in range(8)]),
    (3, 2, [(0, 2), (2, 3)]),
    (3, 4, [(0, 1), (1, 2), (2, 3), (3, 3)]),
    (1, 2, [(0, 1), (1, 1)]),
    (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)]),
])
def test_kv_heads_pad_as_gspmd(kv, model, want):
    """A rank's kv heads: ceil(kv / M) a rank in order, the last ranks fewer
    or none; an even split's chunks where M divides kv."""
    assert [sharding.kv_heads(kv, model, k) for k in range(model)] == want


@pytest.mark.parametrize("name,model", [("kv3", 4), ("kv1", 2), ("whisper", 4)])
def test_cache_holds_each_rank_kv_heads(name, model):
    """``cache_dims`` names the kv-head dim of the self and cross keys and
    values in ``padded`` mode (the reference's spec falls to ``hd`` there);
    ``shard_cache``'s rank k holds ``kv_heads(kv, M, k)`` of the whole
    cache, zero wide past the last kv head, and the ranks' pieces
    concatenated are the whole cache."""
    cfg = _cfg(name)
    mesh = mesh_lib.make_debug_mesh(1, model, device="cpu")
    cache = T.init_cache(cfg, 2, 6, device="cpu")
    for t in tree_leaves(cache):
        t.copy_(torch.arange(t.numel()).reshape(t.shape).to(t.dtype))
    specs = steps.cache_shardings(cfg, mesh, cache)
    dims = dict(tree_leaves_with_path(sharding.cache_dims(cfg, model, cache, specs)))
    kv = [p for p in dims if p.split("/")[-1] in ("k", "v")]
    assert kv and all(dims[p] == len(dict(tree_leaves_with_path(cache))[p].shape) - 2
                      for p in kv)
    if cfg.cross_attention:
        assert "cross/k" in kv
    parts = [dict(tree_leaves_with_path(sharding.shard_cache(cache, sharding.cache_dims(
        cfg, model, cache, specs), k, model))) for k in range(model)]
    for path, whole in tree_leaves_with_path(cache):
        d = dims[path]
        if d < 0:
            assert all(torch.equal(p[path], whole) for p in parts), path
            continue
        for k, p in enumerate(parts):
            a, b = sharding.kv_heads(cfg.n_kv_heads, model, k)
            assert p[path].shape[d] == b - a, (path, k)
        assert torch.equal(torch.cat([p[path] for p in parts], d), whole), path


def test_model_columns_with_a_rank_that_wants_nothing():
    """``InProcessAxes.model_columns`` gives a rank with no wanted ranges a
    zero-wide tensor, and the gradient of the columns the others read."""
    ax = D.InProcessAxes({"data": 1, "model": 4}, "cpu")
    g = torch.Generator().manual_seed(0)
    whole = torch.randn((3, 8), generator=g, requires_grad=True)
    wants = [((0, 2), (3, 4)), ((2, 3),), ((4, 8),), ()]
    got = ax.model_columns(list(whole.chunk(4, 1)), 1, wants)
    assert [t.shape[1] for t in got] == [3, 1, 4, 0]
    assert torch.equal(got[0], torch.cat([whole[:, 0:2], whole[:, 3:4]], 1))
    (grad,) = torch.autograd.grad(sum((t * (i + 1)).sum() for i, t in enumerate(got)), whole)
    assert torch.equal(grad, torch.tensor([1., 1., 2., 1., 3., 3., 3., 3.]).expand(3, 8))


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 1, 0, 2, 1)])
def test_entered_gradient_sums_the_ranks_in_rank_order(order):
    """In process, rank k's reads of an entered tensor (``model_local(x,
    k)``, in any order, a rank reading twice) reach the entered node as
    ((g0 + g1) + g2) + g3, each rank's own reads summed first: bitwise the
    sum a process group takes in rank order."""
    ax = D.InProcessAxes({"data": 1, "model": 4}, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((5, 7), generator=g, dtype=torch.float32, requires_grad=True)
    w = [torch.randn((5, 7), generator=g) * 10.0 ** k for k in range(4)]
    xe = ax.model_enter(x)
    uses = [(k, ax.model_local(xe, k)) for k in order]
    (grad,) = torch.autograd.grad(sum((r * w[k]).sum() for k, r in uses), x)
    per = [sum(w[k] for j, _ in uses if j == k) if k in order else None for k in range(4)]
    want = None
    for t in per:
        if t is not None:
            want = t if want is None else want + t
    assert torch.equal(grad, want)


@pytest.mark.parametrize("name,model,s", [("kv3", 2, 12), ("kv3", 2, 112), ("kv1", 2, 12),
                                         ("whisper", 4, 72)])
def test_padded_layers_gather_no_whole_leaf(name, model, s, monkeypatch):
    """The loss with its backward, the prefill and two decode steps in
    ``padded`` mode gather no leaf whole (no ``model_full``): per
    self-attention layer two all-to-alls (the projections' columns, then
    ``wo``'s rows or the output's columns), per cross-attention layer three
    (q, k and v, the output side), per cross cache one; whichever of the
    weights and the products they move (:func:`T._moves_weights`: the
    weights at 2·112 and whisper's 160 frames, the products at 2·12 and in
    decode)."""
    cfg = _cfg(name)
    ctx = _ctx(model)
    calls = []
    for op in ("model_full", "model_columns"):
        real = getattr(ctx.axes, op)

        def counted(*a, _real=real, _op=op, **k):
            calls.append(_op)
            return _real(*a, **k)

        monkeypatch.setattr(ctx.axes, op, counted)
    _port_run(name, s, ctx)
    n_self = sum(w.kind == "attn" for w in T.layer_slots(cfg)) + cfg.n_enc_layers
    n_cross = cfg.n_layers if cfg.cross_attention else 0
    assert "model_full" not in calls
    # loss (self + cross), prefill (self + cross + cross cache), 2 decodes (self + cross)
    want = (2 * n_self + 3 * n_cross) + (2 * n_self + 3 * n_cross + n_cross) + \
        2 * (2 * (n_self - cfg.n_enc_layers) + 2 * n_cross)
    assert len(calls) == want


# ---------------------------------------------------------------------------
# (b) in process against model 1 and against the reference at model 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,model,s", CASES, ids=[f"{n}-m{m}-s{s}" for n, m, s in CASES])
def test_loss_and_gradients_match_model_one_and_the_reference(name, model, s):
    """The loss and every gradient at model ``model`` within FWD_TOL of the
    port's model 1 and of the reference's (its loss and jax.grad, no
    mesh); ``padded`` mode on the attention (and whisper's encoder and
    cross-attention)."""
    cfg = _cfg(name)
    assert sharding.tp_modes(cfg, model).attn == "padded"
    loss, grads, _, _ = _port_run(name, s, _ctx(model))
    l1, g1, _, _ = _port_one(name, s)
    rl, rg, _ = _ref_one(name, s)
    _, params = _models(name)
    assert abs(loss - l1) <= FWD_TOL and abs(loss - rl) <= FWD_TOL, (loss, l1, rl)
    _close_grads(grads, g1, params, "model 1")
    _close_grads(grads, rg, params, "reference")


@pytest.mark.parametrize("name,model,s", CASES, ids=[f"{n}-m{m}-s{s}" for n, m, s in CASES])
def test_prefill_and_decode_match_model_one_and_the_reference(name, model, s):
    """The prefill's and two decode steps' logits at model ``model`` within
    FWD_TOL of the port's model 1 and of the reference's; the cache (in
    process the ranks' heads side by side: the whole) within FWD_TOL of
    model 1's."""
    _, _, logits, cache = _port_run(name, s, _ctx(model))
    _, _, l1, c1 = _port_one(name, s)
    _, _, rl = _ref_one(name, s)
    for j, (a, b, c) in enumerate(zip(logits, l1, rl)):
        np.testing.assert_allclose(a, b, atol=FWD_TOL, rtol=0, err_msg=f"model 1, step {j}")
        np.testing.assert_allclose(a, c, atol=FWD_TOL, rtol=0, err_msg=f"reference, step {j}")
    for (path, a), b in zip(tree_leaves_with_path(cache), tree_leaves(c1)):
        torch.testing.assert_close(a, b, atol=FWD_TOL, rtol=0, msg=path)


def _train(name, mesh, seq_parallel=False, mode="replicated", seq_len=16):
    cfg = _cfg(name)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          param_mode=mode, attn_chunk=0, seq_parallel=seq_parallel)
    r = trainer.train_loop(cfg, pcfg, TrainConfig(optimizer="sgd", lr=0.5, steps=1,
                                                  device_steps=1), mesh,
                           dcfg=pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                                    global_batch=4,
                                                    num_workers=mesh_lib.num_workers(mesh),
                                                    seed=0))
    return {"params": {p: t.detach().numpy().copy()
                       for p, t in tree_leaves_with_path(r.state["params"])},
            "loss": np.array([h["loss"] for h in r.history]),
            "grad_norm": np.array([h["grad_norm"] for h in r.history])}


@pytest.mark.parametrize("name", ["kv3", "kv1"])
def test_seq_parallel_and_fsdp_on_padded_attention(name):
    """One SGD step at (2, 2) in ``padded`` mode: with seq_parallel within
    LOSS_RTOL / PARAM_ATOL of (2, 1); fsdp bitwise the replicated (2, 2)
    step (the leaves keep their even chunks, so FSDP × TP is unchanged)."""
    one = _train(name, mesh_lib.make_debug_mesh(2, 1, device="cpu"))
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    sp = _train(name, mesh, seq_parallel=True)
    np.testing.assert_allclose(sp["loss"], one["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(sp["grad_norm"], one["grad_norm"], rtol=LOSS_RTOL)
    for path, v in one["params"].items():
        np.testing.assert_allclose(sp["params"][path], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=path)
    rep, fs = _train(name, mesh), _train(name, mesh, mode="fsdp")
    assert _bits_equal(fs["loss"], rep["loss"])
    for path, v in rep["params"].items():
        assert _bits_equal(fs["params"][path], v), path


# ---------------------------------------------------------------------------
# (c) 4 gloo ranks against the in-process runs
# ---------------------------------------------------------------------------


def _serve(name, mesh):
    """A prefill of SERVE's global batch and its decode steps at ``mesh``:
    the logits of each and the cache after the last (under the process
    group the rank's rows and kv heads, in process the whole)."""
    cfg = _cfg(name)
    params = ModelShards(cfg, mesh).cut(T.init_params(cfg, 0, "cpu"))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (SERVE["batch"], SERVE["prompt"])))
    logits, cache = steps.make_prefill_step(cfg, cache_len=SERVE["cache_len"],
                                            mesh=mesh)(params, tokens)
    out = {"logits/0": logits.numpy()}
    decode = steps.make_decode_step(cfg, mesh)
    for j in range(SERVE["decodes"]):
        tok = torch.argmax(logits[:, -1], -1, keepdim=True)
        logits, cache = decode(params, tok, cache, SERVE["prompt"] + j)
        out[f"logits/{j + 1}"] = logits.numpy()
    for path, t in tree_leaves_with_path(cache):
        out[f"cache/{path}"] = t.numpy().copy()
    return out


def job(name, mesh, seq_len):
    """What a gloo rank and the in-process mesh of the same shape run."""
    out = {}
    for key, v in _train(name, mesh, seq_len=seq_len).items():
        if key == "params":
            out.update({f"train/params/{p}": a for p, a in v.items()})
        else:
            out[f"train/{key}"] = v
    out.update({f"serve/{k}": v for k, v in _serve(name, mesh).items()})
    return out


def run_rank(rank: int, rendezvous: str, outdir: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    out = {}
    for jname, (name, model, seq_len) in RANK_JOBS.items():
        mesh = mesh_lib.make_production_mesh(model=model, device="cpu")
        out.update({f"{jname}/{k}": v for k, v in job(name, mesh, seq_len).items()})
        out[f"{jname}/coords"] = np.asarray([mesh.axes.coords["data"],
                                             mesh.axes.coords["model"]])
        out[f"{jname}/all_to_alls"] = np.asarray(mesh.axes.calls["model_all_to_all"])
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The 4 gloo ranks, started once for the module."""
    d = tmp_path_factory.mktemp("attn_padded")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    started = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, os.path.join(ROOT, "tests"),
                                 str(r), str(d / "rendezvous"), str(d)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
               for r in range(WORLD)]
    results = {}

    def wait():
        if not results:
            for r, p in enumerate(started):
                log = p.communicate(timeout=300)[0]
                assert p.returncode == 0, f"rank {r}: {log[-4000:]}"
                results[r] = dict(np.load(d / f"rank{r}.npz"))
        return results

    yield wait
    for p in started:
        p.kill()


@functools.lru_cache(maxsize=None)
def _in_process(jname):
    name, model, seq_len = RANK_JOBS[jname]
    return job(name, mesh_lib.make_debug_mesh(WORLD // model, model, device="cpu"), seq_len)


@pytest.mark.parametrize("jname", list(RANK_JOBS))
def test_gloo_train_step_is_bitwise_the_in_process_run(procs, jname):
    """After one step each rank's params are bitwise its chunk of the
    in-process run's (its even chunk of a split leaf; a replicated leaf
    whole, so equal on every rank, the empty rank's included), and its
    loss and grad norm bitwise; every rank ran the all-to-alls."""
    name, model, _ = RANK_JOBS[jname]
    want = _in_process(jname)
    dims = dict(tree_leaves_with_path(sharding.tp_dims(_cfg(name), model)))
    prefix = "train/params/"
    keys = [k for k in want if k.startswith(prefix)]
    assert len(keys) == len(dims)
    for r, out in procs().items():
        _, k = (int(c) for c in out[f"{jname}/coords"])
        assert int(out[f"{jname}/all_to_alls"]) > 0, r
        for key in keys:
            t = torch.from_numpy(want[key])
            d = dims[key[len(prefix):]]
            if d >= 0:
                t = t.chunk(model, d)[k]
            assert _bits_equal(out[f"{jname}/{key}"], t.numpy()), (r, key)
        for key in ("train/loss", "train/grad_norm"):
            assert _bits_equal(out[f"{jname}/{key}"], want[key]), (r, key)


@pytest.mark.parametrize("jname", list(RANK_JOBS))
def test_gloo_caches_are_each_rank_kv_heads(procs, jname):
    """A prefill and 2 decode steps on the ranks: each rank's logits are its
    rows of the in-process run's, bitwise; each rank's cache is its rows of
    ``shard_cache`` of the in-process whole one (its kv heads, zero wide on
    the rank past the last head), bitwise, and the ranks' caches gathered
    over the model axis are that whole cache, within FWD_TOL of the model-1
    cache."""
    name, model, _ = RANK_JOBS[jname]
    cfg = _cfg(name)
    want = _in_process(jname)
    data = WORLD // model
    rows = SERVE["batch"] // data
    meta = T.init_cache(cfg, SERVE["batch"], SERVE["cache_len"], device="meta")
    paths = [p for p, _ in tree_leaves_with_path(meta)]
    cache = tree_unflatten_like(meta, [torch.from_numpy(want[f"serve/cache/{p}"]) for p in paths])
    mesh = mesh_lib.make_debug_mesh(data, model, device="cpu")
    dims = sharding.cache_dims(cfg, model, cache, steps.cache_shardings(cfg, mesh, cache))
    got = procs()
    pieces = {}
    for r, out in got.items():
        w, k = (int(c) for c in out[f"{jname}/coords"])
        for j in range(SERVE["decodes"] + 1):
            assert _bits_equal(out[f"{jname}/serve/logits/{j}"],
                               want[f"serve/logits/{j}"][rows * w:rows * (w + 1)]), (r, j)
        part = sharding.shard_cache(cache, dims, k, model)
        for (path, t), d in zip(tree_leaves_with_path(part), tree_leaves(dims)):
            lead = 1 if path.startswith("blocks/") else 0
            mine = t.numpy() if path.endswith("kpos") else t.narrow(lead, rows * w, rows).numpy()
            assert _bits_equal(out[f"{jname}/serve/cache/{path}"], mine), (r, path, d)
            if w == 0:
                pieces.setdefault(path, {})[k] = (out[f"{jname}/serve/cache/{path}"], d)
    assert any(p[model - 1][0].shape[p[model - 1][1]] == 0 for p in pieces.values()
               if p[model - 1][1] >= 0)
    one = _serve(name, mesh_lib.make_debug_mesh(1, 1, device="cpu"))
    for path, per in pieces.items():
        d = per[0][1]
        whole = per[0][0] if d < 0 else np.concatenate([per[k][0] for k in range(model)], d)
        lead = 1 if path.startswith("blocks/") else 0
        ref = one[f"cache/{path}"]
        if not path.endswith("kpos"):
            ref = np.take(ref, range(rows), axis=lead)
        np.testing.assert_allclose(whole, ref, atol=FWD_TOL, rtol=0, err_msg=path)
