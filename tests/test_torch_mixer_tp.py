"""The ``ssm`` and ``rec`` mixers on each rank's heads and channels over the
model axis (``sharding.TPModes.ssm`` ``heads`` / ``gathered``,
``TPModes.rec`` ``channels``), with their serving states split as the
reference's ``cache_shardings`` splits them.

The reference's model-axis forward does not run in this jax (ROADMAP C),
so the split mixers are held against the port's own model 1 (in process,
each layer's model ranks in turn on the global view) and across processes
(4 gloo ranks at (data 2, model 2), spawned once for the module and run
while the in-process tests do).  Smoke widths, float32; a gloo rank's
params are its shards, its caches its rows and its heads or channels.
Also here: the qk-norm scales of ``heads``-mode attention on the ranks
(qwen3's kind), whose gradient is the ranks' summed.

Tolerances, stated where used:
- model 2 and 4 in process against model 1: logits and loss 1e-5 absolute
  (tests/test_torch_tp.py's ``FWD_TOL``), gradients 1e-5 times max(1, the
  leaf's largest model-1 gradient), caches 1e-5 absolute;
- seq_parallel at (2, 2) against (2, 1), 1 SGD step of 0.5: loss and grad
  norm 1e-6 relative, params 1e-5 absolute (``LOSS_RTOL`` / ``PARAM_ATOL``);
- fsdp at (2, 2) against replicated (2, 2), and the gloo ranks against the
  in-process (2, 2) run: bitwise (a sum of two partials is the same in
  either order; the all-to-all moves the bits as they are).

Serial time: ~25 s on 2 threads (the gloo ranks run beside the in-process
tests).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import distributed as D
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, trainer
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ModelShards
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten_like

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4  # the gloo ranks: (data 2, model 2)
FWD_TOL = 1e-5
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
ARCHS = ("mamba2-2.7b", "recurrentgemma-2b")
IN_PROJ = ("w_a", "w_bg", "w_bx", "w_in", "w_xg")
# a smoke mamba2 whose 6 heads do not divide over 4 ranks while its packed
# w_in (2·96 + 2·9 + 6 = 216 columns) does: the ``gathered`` mode
ODD_HEADS = dict(d_model=48, ssm=dict(d_state=9, head_dim=16, expand=2, conv_width=4,
                                      chunk=32))
# the gloo jobs' train cells: (config, ParallelConfig.param_mode)
TRAIN_CELLS = {"mamba2": ("mamba2-2.7b", "replicated"),
               "recurrentgemma": ("recurrentgemma-2b", "replicated"),
               "mamba2_fsdp": ("mamba2-2.7b", "fsdp"),
               "recurrentgemma_fsdp": ("recurrentgemma-2b", "fsdp"),
               "qk_norm_heads": ("qwen3-heads", "replicated")}
SERVE = dict(batch=4, prompt=8, cache_len=12, decodes=2)

RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_mixer_tp as T
T.run_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
"""


def _cfg(arch, **over):
    if arch == "qwen3-heads":  # qwen3's qk-norm on two kv heads: heads mode at model 2
        return dataclasses.replace(configs.get_smoke_config("qwen3-14b"), n_heads=4,
                                   n_kv_heads=2, dtype="float32")
    if arch == "odd-heads":
        base = configs.get_smoke_config("mamba2-2.7b")
        return dataclasses.replace(base, dtype="float32", d_model=ODD_HEADS["d_model"],
                                   ssm=dataclasses.replace(base.ssm, **ODD_HEADS["ssm"]))
    return dataclasses.replace(configs.get_smoke_config(arch), dtype="float32", **over)


def _ctx(model, data=1):
    return sharding.model_ctx(mesh_lib.make_debug_mesh(data, model, device="cpu"))


def _tokens(cfg, b, s, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)))


def _loss_and_grads(params, batch, cfg, ctx):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = T.loss_fn(tree_unflatten_like(params, leaves), batch, cfg, kv_block=0, ctx=ctx)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                         b.view(np.uint8))


def _train(arch, mode, mesh, seq_parallel=False):
    cfg = _cfg(arch)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          param_mode=mode, attn_chunk=0, seq_parallel=seq_parallel)
    r = trainer.train_loop(cfg, pcfg, TrainConfig(optimizer="sgd", lr=0.5, steps=1,
                                                  device_steps=1), mesh,
                           dcfg=pipeline.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4,
                                                    num_workers=mesh_lib.num_workers(mesh),
                                                    seed=0),
                           attack=AttackConfig("alie", 0.25))
    return {"params": {p: t.detach().numpy().copy()
                       for p, t in tree_leaves_with_path(r.state["params"])},
            "loss": np.array([h["loss"] for h in r.history]),
            "grad_norm": np.array([h["grad_norm"] for h in r.history])}


def _serve(arch, mesh):
    """A prefill of SERVE's global batch and its decode steps at ``mesh``:
    the logits of each and the cache after the last (under the process
    group the rank's rows and heads or channels, in process the whole)."""
    cfg = _cfg(arch)
    params = ModelShards(cfg, mesh).cut(T.init_params(cfg, 0, "cpu"))  # the rank's shards
    tokens = _tokens(cfg, SERVE["batch"], SERVE["prompt"])
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


def jobs(mesh):
    """The jobs both the gloo ranks and the in-process (2, 2) mesh run."""
    out = {}
    for cell, (arch, mode) in TRAIN_CELLS.items():
        for key, v in _train(arch, mode, mesh).items():
            if key == "params":
                out.update({f"train/{cell}/params/{p}": a for p, a in v.items()})
            else:
                out[f"train/{cell}/{key}"] = v
    for arch in ARCHS:
        out.update({f"serve/{arch}/{k}": v for k, v in _serve(arch, mesh).items()})
    return out


def run_rank(rank: int, rendezvous: str, outdir: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    mesh = mesh_lib.make_production_mesh(model=2, device="cpu")
    out = jobs(mesh)
    out["coords"] = np.asarray([mesh.axes.coords["data"], mesh.axes.coords["model"]])
    out["calls"] = np.asarray([mesh.axes.calls["model_all_to_all"],
                               mesh.axes.calls["model_gather"]])
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The 4 gloo ranks, started once for the module."""
    d = tmp_path_factory.mktemp("mixer_tp")
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


@pytest.fixture(scope="module")
def in_process(procs):
    """The ranks' jobs over the in-process (2, 2) mesh (run while they do)."""
    return jobs(mesh_lib.make_debug_mesh(2, 2, device="cpu"))


# ---------------------------------------------------------------------------
# (a) the plan: modes, in-projections on their shards, states split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("model", [2, 16])
def test_tp_plan_shards_the_in_projections_and_splits_the_states(arch, model):
    """At published widths, model 2 and 16: the mixer's mode is ``heads``
    (mamba2's 80 heads) or ``channels`` (recurrentgemma's 2,560), every
    in-projection the rules split is ``shard`` in ``tp_plan``, and
    ``cache_dims`` splits ``ssd`` on its heads (the ``ssm`` conv window a
    HeadsConv of its x channels) and ``rec``'s ``conv`` and ``h`` on their
    channels: the reference's specs' dims."""
    cfg = configs.get_config(arch)
    modes = sharding.tp_modes(cfg, model)
    assert (modes.ssm, modes.rec) == (("heads", None) if cfg.ssm is not None
                                      else (None, "channels"))
    plan = sharding.tp_plan(cfg, model)
    mixer = {p: m for p, m in plan.items() if p.split("/")[-1] in IN_PROJ}
    want = {"w_in"} if cfg.ssm is not None else {"w_a", "w_bg", "w_bx", "w_xg"}
    assert {p.split("/")[-1] for p in mixer} == want
    assert all(m == "shard" for _, m in mixer.values())
    mesh = mesh_lib.make_debug_mesh(1, model, device="cpu")
    cache = T.init_cache(cfg, 2, 16, device="meta")
    specs = steps.cache_shardings(cfg, mesh, cache)
    spec_of = []
    tree_map(lambda _, s: spec_of.append(s), cache, specs)
    spec = {p: s for (p, _), s in zip(tree_leaves_with_path(cache), spec_of)}
    dims = dict(tree_leaves_with_path(sharding.cache_dims(cfg, model, cache, specs)))
    states = [p for p in dims if p.split("/")[-1] in ("conv", "ssd", "h")]
    assert states
    for path in states:
        d, name = dims[path], path.split("/")[-1]
        if name == "conv" and cfg.ssm is not None:
            assert d == sharding.HeadsConv(len(spec[path]) - 1, T._ssm_dims(cfg)[1]), path
        else:
            assert d >= 0 and spec[path][d] == "model", path


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("model", [2, 4])
def test_the_split_mixers_gather_no_weight(arch, model, monkeypatch):
    """A mixer layer's forward, its backward and a decode step at model 2
    and 4 move activations only: no ``model_full`` (a weight's gather);
    one all-to-all (``model_columns``, the ssm) or one gather of the conv
    output (``model_gather``, the rec) a layer; within FWD_TOL of model 1,
    the rank-summed gradients of the replicated per-head / per-channel
    leaves included."""
    cfg = _cfg(arch)
    ctx = _ctx(model)
    calls = []
    for name in ("model_full", "model_columns", "model_gather"):
        real = getattr(ctx.axes, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(ctx.axes, name, counted)
    kind = "ssm" if cfg.ssm is not None else "rec"
    where = next(w for w in T.layer_slots(cfg) if w.kind == kind)
    params = T.init_params(cfg, 0, "cpu")
    leaves = {n: t.detach().requires_grad_(True)
              for n, t in T.layer_at(params, where).items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, cfg.d_model))
                         .astype(np.float32))
    fwd = T._ssm_layer_fwd if kind == "ssm" else T._rec_layer_fwd
    outs = {}
    for m, c in ((1, sharding.NULL_CTX), (model, ctx)):
        y, _, state = fwd(leaves, x, cfg, c)
        grads = torch.autograd.grad(y.square().sum(), list(leaves.values()), allow_unused=True)
        outs[m] = (y.detach(), state, grads)
    assert calls == ["model_columns" if kind == "ssm" else "model_gather"]
    torch.testing.assert_close(outs[model][0], outs[1][0], atol=FWD_TOL, rtol=0)
    for name, a, b in zip(leaves, outs[model][2], outs[1][2]):
        if b is None:
            assert a is None, name
            continue
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, atol=FWD_TOL * scale, rtol=0, msg=name)
    for key in outs[1][1]:
        torch.testing.assert_close(outs[model][1][key], outs[1][1][key], atol=FWD_TOL, rtol=0)
    calls.clear()
    cache = T.init_cache(cfg, 2, 4, device="cpu")
    with torch.no_grad():
        dec = T._ssm_decode if kind == "ssm" else T._rec_decode
        lc = T.layer_at(cache, where)
        dec(leaves, x[:, :1], lc, cfg, ctx)
    assert calls == ["model_columns" if kind == "ssm" else "model_gather"]


def test_heads_that_do_not_divide_take_gathered():
    """A mamba2 whose 6 heads do not divide over 4 ranks, while its packed
    w_in does: ``gathered`` (w_in gathered in ``tp_plan``, the states
    whole), chosen by the shape; the forward, the loss, every gradient and
    the serving states within FWD_TOL of model 1."""
    cfg = _cfg("odd-heads")
    assert T._ssm_dims(cfg)[2] == 6 and (2 * 96 + 2 * 9 + 6) % 4 == 0
    modes = sharding.tp_modes(cfg, 4)
    assert modes.ssm == "gathered" and modes.mixer_in == ("w_in",)
    assert sharding.tp_modes(cfg, 2).ssm == "heads"
    plan = sharding.tp_plan(cfg, 4)
    assert plan["blocks/p0_ssm/w_in"] == (2, "gathered")
    assert plan["blocks/p0_ssm/w_out"] == (1, "shard")
    ctx = _ctx(4)
    params = T.init_params(cfg, 0, "cpu")
    batch = {"tokens": _tokens(cfg, 2, 12, 7), "labels": _tokens(cfg, 2, 12, 8)}
    l1, g1 = _loss_and_grads(params, batch, cfg, sharding.NULL_CTX)
    l4, g4 = _loss_and_grads(params, batch, cfg, ctx)
    assert abs(float(l4) - float(l1)) <= FWD_TOL
    for (path, _), a, b in zip(tree_leaves_with_path(params), g4, g1):
        torch.testing.assert_close(a, b, atol=FWD_TOL * max(1.0, float(b.abs().max())), rtol=0,
                                   msg=path)
    with torch.no_grad():
        _, c1 = T.prefill(params, batch["tokens"], cfg, cache_len=14)
        _, c4 = T.prefill(params, batch["tokens"], cfg, cache_len=14, ctx=ctx)
    for (path, a), b in zip(tree_leaves_with_path(c4), tree_leaves(c1)):
        torch.testing.assert_close(a, b, atol=FWD_TOL, rtol=0, msg=path)
    mesh = mesh_lib.make_debug_mesh(1, 4, device="cpu")
    dims = sharding.cache_dims(cfg, 4, c4, steps.cache_shardings(cfg, mesh, c4))
    assert all(d == -1 for d in tree_leaves(dims))


def test_model_columns_in_process_is_the_slices_and_their_gradient():
    """``InProcessAxes.model_columns``: each rank's wanted ranges of the
    chunks concatenated, a column two ranks want going to both, and its
    gradient those ranks' summed."""
    ax = D.InProcessAxes({"data": 1, "model": 2}, "cpu")
    g = torch.Generator().manual_seed(0)
    whole = torch.randn((3, 10), generator=g, requires_grad=True)
    wants = [((0, 2), (6, 10)), ((2, 4), (6, 10))]
    got = ax.model_columns(list(whole.chunk(2, 1)), 1, wants)
    assert torch.equal(got[0], torch.cat([whole[:, 0:2], whole[:, 6:10]], 1))
    assert torch.equal(got[1], torch.cat([whole[:, 2:4], whole[:, 6:10]], 1))
    w0, w1 = torch.randn(got[0].shape, generator=g), torch.randn(got[1].shape, generator=g)
    (grad,) = torch.autograd.grad((got[0] * w0).sum() + (got[1] * w1).sum(), whole)
    want = torch.zeros(3, 10)
    want[:, 0:2], want[:, 2:4] = w0[:, :2], w1[:, :2]
    want[:, 6:10] = w0[:, 2:] + w1[:, 2:]
    assert torch.equal(grad, want)


# ---------------------------------------------------------------------------
# (b) the train step's paths on the split mixers, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_and_fsdp_on_the_split_mixers(arch):
    """One SGD step at (2, 2): with seq_parallel against (2, 1) within
    LOSS_RTOL / PARAM_ATOL; fsdp bitwise the replicated (2, 2) step."""
    one = _train(arch, "replicated", mesh_lib.make_debug_mesh(2, 1, device="cpu"))
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    sp = _train(arch, "replicated", mesh, seq_parallel=True)
    np.testing.assert_allclose(sp["loss"], one["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(sp["grad_norm"], one["grad_norm"], rtol=LOSS_RTOL)
    for path, v in one["params"].items():
        np.testing.assert_allclose(sp["params"][path], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=path)
    rep, fs = _train(arch, "replicated", mesh), _train(arch, "fsdp", mesh)
    assert _bits_equal(fs["loss"], rep["loss"])
    for path, v in rep["params"].items():
        assert _bits_equal(fs["params"][path], v), path


# ---------------------------------------------------------------------------
# (c) 4 gloo ranks at (data 2, model 2) against the in-process run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(TRAIN_CELLS))
def test_gloo_train_step_is_bitwise_the_in_process_run(procs, in_process, cell):
    """Each rank's params after one step are bitwise its chunk of the
    in-process (2, 2) step's (replicated leaves whole; under fsdp FSDP
    chunk w of model chunk k), its loss bitwise, its grad norm bitwise
    (replicated) or within 1e-6 (fsdp's psum over the workers).  The
    qk-norm cell fails if the ranks' scales take only their own heads'
    gradient."""
    arch, mode = TRAIN_CELLS[cell]
    cfg = _cfg(arch)
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    if mode == "fsdp":
        fd = dict(tree_leaves_with_path(steps.fsdp_dims(cfg, mesh)))
        md = dict(tree_leaves_with_path(steps.fsdp_model_dims(cfg, mesh)))
    else:
        fd = {}
        md = dict(tree_leaves_with_path(sharding.tp_dims(cfg, 2)))
    prefix = f"train/{cell}/params/"
    keys = [k for k in in_process if k.startswith(prefix)]
    assert len(keys) == len(md)
    for r, out in procs().items():
        w, k = (int(c) for c in out["coords"])
        for key in keys:
            path = key[len(prefix):]
            t = torch.from_numpy(in_process[key])
            if md[path] >= 0:
                t = t.chunk(2, md[path])[k]
            if fd.get(path, -1) >= 0:
                t = t.chunk(2, fd[path])[w]
            assert _bits_equal(out[key], t.numpy()), (r, key)
        assert _bits_equal(out[f"train/{cell}/loss"], in_process[f"train/{cell}/loss"])
        np.testing.assert_allclose(out[f"train/{cell}/grad_norm"],
                                   in_process[f"train/{cell}/grad_norm"],
                                   rtol=0 if mode == "replicated" else LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gloo_rank_states_are_the_whole_state_chunks(procs, in_process, arch):
    """A prefill and 2 decode steps on the ranks: each rank's logits are its
    rows of the in-process (2, 2) run's, and each rank's cache is its rows
    of ``shard_cache`` of the whole one (``ssd`` its heads, ``rec``'s
    ``conv`` and ``h`` its channels, the ``ssm`` conv window its x channels
    and B and C), bitwise; the all-to-all or the gather ran on every
    rank."""
    cfg = _cfg(arch)
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    pre = f"serve/{arch}/"
    cache = tree_unflatten_like(
        T.init_cache(cfg, SERVE["batch"], SERVE["cache_len"], device="meta"),
        [torch.from_numpy(in_process[f"{pre}cache/{p}"]) for p, _ in tree_leaves_with_path(
            T.init_cache(cfg, SERVE["batch"], SERVE["cache_len"], device="meta"))])
    dims = sharding.cache_dims(cfg, 2, cache, steps.cache_shardings(cfg, mesh, cache))
    for r, out in procs().items():
        w, k = (int(c) for c in out["coords"])
        assert min(out["calls"]) > 0
        for j in range(SERVE["decodes"] + 1):
            assert _bits_equal(out[f"{pre}logits/{j}"],
                               in_process[f"{pre}logits/{j}"][2 * w:2 * w + 2]), (r, j)
        part = sharding.shard_cache(cache, dims, k, 2)
        for (path, t), d in zip(tree_leaves_with_path(part), tree_leaves(dims)):
            lead = 1 if path.startswith("blocks/") else 0
            rows = t.numpy() if path.endswith("kpos") else t.narrow(lead, 2 * w, 2).numpy()
            assert _bits_equal(out[f"{pre}cache/{path}"], rows), (r, path, d)


# ---------------------------------------------------------------------------
# (d) the committed dry-run: the split mixers' decode on the single mesh
# ---------------------------------------------------------------------------


def _swept(arch, shape, mesh="single"):
    import json

    with open(os.path.join(ROOT, "dryrun_torch_results.jsonl")) as f:
        return next(r for r in map(json.loads, f)
                    if (r["arch"], r["shape"], r["mesh"]) == (arch, shape, mesh))


def test_swept_mamba2_decode_moves_no_weight():
    """mamba2-2.7b decode_32k on the single mesh (data 16 × model 16, 8 rows
    a worker, bf16): the model axis moves activations only, in closed
    form: the embedding's d_model lookups gathered, one all-to-all a layer
    of each rank's z, x, dt columns and B, C (2·di/16 + 2n + H/16 a row),
    all-reduces of ``w_out``'s partials and ``out_norm``'s f32 sums a layer
    and of the lm head's partial logits; the planned peak under 1 GB (the
    SSD state a rank's 5 of 80 heads)."""
    rec = _swept("mamba2-2.7b", "decode_32k")
    cfg = configs.get_config("mamba2-2.7b")
    s_cfg, di, nheads, _ = T._ssm_dims(cfg)
    rows, b, L, D = 8, 2, cfg.n_layers, cfg.d_model
    cols = 2 * di // 16 + 2 * s_cfg.d_state + nheads // 16
    assert rec["status"] == "ok" and rec["collectives_by_axis"] == {"model": {
        "all-gather": rows * D * b, "all-to-all": L * rows * cols * b,
        "all-reduce": L * rows * (D * b + 4) + rows * cfg.vocab * b}}
    assert rec["peak_memory_in_bytes"] < 1e9


def test_swept_recurrent_plans_fall():
    """The sweep's recurrentgemma-2b decode_32k all-gathers at most 0.25 GB
    a rank (the MQA attention's gathered leaves; the rec mixer's conv
    output is (8, 1, 2,560) a layer), and mamba2-2.7b's train_4k plans
    under 2.55e14 FLOPs a rank."""
    assert _swept("recurrentgemma-2b", "decode_32k")["collectives"]["all-gather"] <= 0.25e9
    assert _swept("mamba2-2.7b", "train_4k")["flops"] < 2.55e14
