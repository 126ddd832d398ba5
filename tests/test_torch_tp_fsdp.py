"""FSDP on the model axis in the port (``param_mode='fsdp'`` at a mesh's
``model`` > 1): each leaf split over the workers on its FSDP dim and over
``model`` on its model dim (``launch/steps.fsdp_param_shardings``), a
leaf whose FSDP dim took its model dim ("the model yields") stored whole
over ``model`` (``fsdp_model_dims``, ``fsdp_rank_shard``), the rank's
gather over the workers of its model coordinate and its cut to its model
chunk (``core/distributed.Collectives.model_cut``), and fsdp's grad-norm
rule at model 2.

The reference's fsdp step at a model axis raises ``ShardingTypeError`` in
this jax, so the model-2 run is held against the port's replicated model-2
run, in process and on 4 gloo ranks at (data 2, model 2), and the
reference's specs, pure shape functions, are computed in this process with
a stand-in mesh (as tests/test_torch_fsdp.py does).  The 4 gloo ranks are
spawned once for the module (a ``file://`` rendezvous, every join with a
timeout) and run :func:`jobs` while the in-process tests run.  About 35 s
serially.

Cells: llama3.2-3b's smoke config, a tiny llama whose vocab (127) is odd,
so that ``embed`` and ``lm_head`` fall back to their model dim, and
granite-moe-1b-a400m's smoke config (experts split over ``model``); f32,
AdamW 1e-2, 2 steps, gather median under alie alpha 0.25.

Tolerances, stated where used:
- fsdp at (2, 2) against replicated at (2, 2), in process: bitwise (losses,
  every step's aggregation inputs as each worker's multiset of values,
  params);
- the gloo ranks against the in-process run: bitwise (each rank's shards of
  the params, losses); grad norms 1e-6 relative (a backend SUM);
- the grad norm against fsdp's rule recomputed from the step's aggregate:
  1e-6 relative;
- specs, dims and shard shapes: equal.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import aggregators
from repro_torch.core import distributed as D
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, trainer
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, get_optimizer
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4  # the gloo ranks: (data 2, model 2)
STEPS, LR = 2, 1e-2
NORM_RTOL = 1e-6
ODD_VOCAB = 127
CELLS = {"llama": "llama3.2-3b", "odd_vocab": "odd", "granite": "granite-moe-1b-a400m"}
DATA = dict(seq_len=16, global_batch=4, num_workers=2, seed=0)
SPEC_ARCHS = ("grok-1-314b", "llama3-405b", "qwen3-14b", "granite-moe-1b-a400m",
              "whisper-small", "internvl2-1b")
# the leaves whose FSDP dim takes their model dim at (data 4, model 2)
YIELDS = {"granite-moe-1b-a400m": {"embed": 1, "lm_head": 0},
          "whisper-small": {"embed": 1, "lm_head": 0},
          "internvl2-1b": {"embed": 1, "lm_head": 0}}

RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_tp_fsdp as T
T.run_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
"""


def _cfg(name):
    if name == "odd":
        return dataclasses.replace(configs.get_smoke_config("llama3.2-3b"), vocab=ODD_VOCAB,
                                   dtype="float32")
    return dataclasses.replace(configs.get_smoke_config(name), dtype="float32")


def _pcfg(mode):
    return ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          param_mode=mode, attn_chunk=0)


@contextlib.contextmanager
def _recorded(calls):
    """Each aggregation call's inputs, per worker (row) its values, appended
    to ``calls``."""
    real = aggregators.aggregate_leaves

    def rec(leaves, method, beta=0.1):
        calls.append(np.concatenate([x.detach().reshape(x.shape[0], -1).float().numpy()
                                     for x in leaves], axis=1))
        return real(leaves, method, beta)

    aggregators.aggregate_leaves = rec
    try:
        yield
    finally:
        aggregators.aggregate_leaves = real


def _run(name, mode, mesh, record=None):
    cfg = _cfg(name)
    calls = []
    ctx = _recorded(calls) if record else contextlib.nullcontext()
    with ctx:
        r = trainer.train_loop(cfg, _pcfg(mode), TrainConfig(optimizer="adamw", lr=LR,
                                                             steps=STEPS, device_steps=1),
                               mesh, dcfg=pipeline.DataConfig(vocab=cfg.vocab, **DATA),
                               attack=AttackConfig("alie", 0.25))
    out = {"params": {p: t.detach().numpy().copy() for p, t in
                      tree_leaves_with_path(r.state["params"])},
           "loss": np.array([h["loss"] for h in r.history]),
           "grad_norm": np.array([h["grad_norm"] for h in r.history])}
    if record:
        per = len(calls) // STEPS
        # a step's aggregation inputs as each worker's sorted values
        out["inputs"] = [np.sort(np.concatenate(calls[i * per:(i + 1) * per], axis=1), axis=1)
                         for i in range(STEPS)]
    return out


def jobs(mesh):
    """The fsdp cells on ``mesh``: {cell: run}, params the global view in
    process and the rank's shards under the process group."""
    return {cell: _run(name, "fsdp", mesh) for cell, name in CELLS.items()}


def run_rank(rank: int, rendezvous: str, outdir: str) -> None:
    """One rank of the module's process group at (data 2, model 2)."""
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    mesh = mesh_lib.make_production_mesh(model=2, device="cpu")
    flat = {}
    for cell, out in jobs(mesh).items():
        flat[f"{cell}/loss"], flat[f"{cell}/grad_norm"] = out["loss"], out["grad_norm"]
        for p, v in out["params"].items():
            flat[f"{cell}/params/{p}"] = v
    flat["coords"] = np.array([mesh_lib.worker_index(mesh), mesh_lib.model_rank(mesh)])
    np.savez(f"{outdir}/rank{rank}.npz", **flat)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_fsdp")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, os.path.join(ROOT, "tests"),
                               str(r), str(d / "rendezvous"), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    done = {}

    def wait():
        if not done:
            for r, p in enumerate(procs):
                log = p.communicate(timeout=300)[0]
                assert p.returncode == 0, f"rank {r}: {log[-4000:]}"
            done["outs"] = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
        return done["outs"]

    yield wait
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def in_process(ranks):
    """The fsdp and replicated runs at (2, 2) in process, each step's
    aggregation inputs recorded (run while the ranks do)."""
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    return {mode: {cell: _run(name, mode, mesh, record=True) for cell, name in CELLS.items()}
            for mode in ("fsdp", "replicated")}


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                         b.view(np.uint8))


# ---------------------------------------------------------------------------
# (a) specs, dims and the rank's shard shapes against the reference
# ---------------------------------------------------------------------------


def _ref_leaves(tree, is_leaf=None):
    import jax

    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _is_spec(x):
    from jax.sharding import PartitionSpec

    return isinstance(x, PartitionSpec)


def _port_specs(cfg, tree):
    out = []
    tree_map(lambda _, x: out.append(x), T.meta_params(cfg), tree)
    return out


def _mesh(shape, per_rank=False):
    return mesh_lib.Mesh(("data", "model"), shape, torch.device("cpu"),
                         D.InProcessAxes({"data": shape[0], "model": shape[1]}, "cpu"),
                         per_rank=per_rank)


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_fsdp_dims_and_specs_at_model_two_match_the_reference(arch, monkeypatch):
    """At make_debug_mesh(4, 2)'s shape: ``fsdp_dims`` and
    ``fsdp_param_shardings`` equal the reference's; a rank's shard shapes
    (``abstract_params_fsdp`` under a process group, ``fsdp_rank_shard``)
    are each leaf's shape divided as the reference's spec divides it (the
    worker axis on the FSDP dim, ``model`` on the model dim, a model-yields
    leaf whole over ``model``); and the yields are the odd-vocab leaves."""
    cfg, rcfg = configs.get_config(arch), ref_get_config(arch)
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    rmesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((4, 2)))
    mesh = _mesh((4, 2))
    assert tree_leaves(steps.fsdp_dims(cfg, mesh)) == [
        d for _, d in _ref_leaves(ref_steps.fsdp_dims(rcfg, rmesh))]
    specs, _ = steps.fsdp_param_shardings(cfg, mesh)
    rspecs = [tuple(s) for _, s in _ref_leaves(ref_steps.fsdp_param_shardings(rcfg, rmesh)[0],
                                               _is_spec)]
    assert _port_specs(cfg, specs) == rspecs
    size = {"data": 4, "model": 2}
    want = [tuple(n // size[e] if e in size else n for n, e in
                  zip(t.shape, list(spec) + [None] * (t.dim() - len(spec))))
            for t, spec in zip(tree_leaves(T.meta_params(cfg)), rspecs)]
    rank = steps.abstract_params_fsdp(cfg, _mesh((4, 2), per_rank=True))
    assert [tuple(t.shape) for t in tree_leaves(rank)] == want
    tdims = dict(tree_leaves_with_path(sharding.tp_dims(cfg, 2)))
    fdims = dict(tree_leaves_with_path(steps.fsdp_dims(cfg, mesh)))
    yields = {p.split("/")[-1]: d for p, d in tdims.items() if d >= 0 and fdims[p] == d}
    assert yields == YIELDS.get(arch, {})
    mdims = dict(tree_leaves_with_path(steps.fsdp_model_dims(cfg, mesh)))
    assert mdims == {p: -1 if fdims[p] == d else d for p, d in tdims.items()}


def test_the_odd_vocab_cell_yields_its_embedding_and_head():
    """The tiny odd-vocab llama at (2, 2): ``embed`` (127, D) and ``lm_head``
    (D, 127) are split on d_model by the model axis and take that dim for
    FSDP too; llama's smoke config and granite's have no such leaf."""
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    for name, want in (("odd", {"embed": 1, "lm_head": 0}), ("llama3.2-3b", {}),
                       ("granite-moe-1b-a400m", {})):
        cfg = _cfg(name)
        tdims = dict(tree_leaves_with_path(sharding.tp_dims(cfg, 2)))
        fdims = dict(tree_leaves_with_path(steps.fsdp_dims(cfg, mesh)))
        got = {p: d for p, d in tdims.items() if d >= 0 and fdims[p] == d}
        assert got == want, name


def test_fsdp_rank_shard_cuts_the_model_chunk_then_the_worker_chunk():
    """``fsdp_rank_shard`` on a process-group stand-in: chunk (model rank)
    along the stored model dim, then chunk (worker) along the FSDP dim; a
    model-yields leaf only its worker chunk."""
    cfg = _cfg("odd")
    full = T.init_params(cfg, 0, "cpu")
    fd = dict(tree_leaves_with_path(steps.fsdp_dims(cfg, _mesh((2, 2)))))
    md = dict(tree_leaves_with_path(steps.fsdp_model_dims(cfg, _mesh((2, 2)))))
    for w in range(2):
        for k in range(2):
            mesh = _mesh((2, 2), per_rank=True)
            mesh.axes.coords = {"data": w, "model": k}
            got = dict(tree_leaves_with_path(steps.fsdp_rank_shard(full, cfg, mesh)))
            for path, t in tree_leaves_with_path(full):
                if md[path] >= 0:
                    t = t.chunk(2, md[path])[k]
                if fd[path] >= 0:
                    t = t.chunk(2, fd[path])[w]
                assert torch.equal(got[path], t), (w, k, path)
    assert md["embed"] == md["lm_head"] == -1


# ---------------------------------------------------------------------------
# (b) fsdp at (2, 2) is the replicated model-2 run, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS))
def test_fsdp_at_model_two_is_bitwise_replicated(in_process, cell):
    fs, rep = in_process["fsdp"][cell], in_process["replicated"][cell]
    assert _bits_equal(fs["loss"], rep["loss"])
    for a, b in zip(fs["inputs"], rep["inputs"]):
        assert _bits_equal(a, b)
    assert fs["params"].keys() == rep["params"].keys()
    for path, v in fs["params"].items():
        assert _bits_equal(v, rep["params"][path]), path


@pytest.mark.parametrize("cell", list(CELLS))
def test_fsdp_grad_norm_rule_at_model_two(cell):
    """fsdp's grad norm at (2, 2) is the reference's rule on the step's
    aggregate: each leaf's sum of squares, a leaf the workers replicate
    (FSDP dim -1) counted m times (psummed over the workers) and every
    other once, its model shards' sums added."""
    cfg = _cfg(CELLS[cell])
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    seen = []
    adamw = get_optimizer("adamw", LR)
    opt = Optimizer(adamw.init, lambda g, *a: (seen.append(g), adamw.update(g, *a))[1])
    step = steps.make_train_step(cfg, _pcfg("fsdp"), mesh, opt, AttackConfig("alie", 0.25))
    params = T.init_params(cfg, 0, "cpu")
    batch = {k: v for k, v in pipeline.make_lm_batch(pipeline.DataConfig(
        vocab=cfg.vocab, **DATA), 0, None, device="cpu").items() if k in ("tokens", "labels")}
    _, _, met = step(params, opt.init(params), batch, 0)
    dims = tree_leaves(steps.fsdp_dims(cfg, mesh))
    want = sum((2 if d < 0 else 1) * float(torch.sum(g.double() ** 2))
               for g, d in zip(tree_leaves(seen[0]), dims)) ** 0.5
    np.testing.assert_allclose(float(met["grad_norm"]), want, rtol=NORM_RTOL)


# ---------------------------------------------------------------------------
# (c) the gloo ranks hold the global view's chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS))
def test_ranks_hold_the_global_view_chunks(ranks, in_process, cell):
    """Rank (w, k) holds FSDP chunk w of model chunk k of every leaf of the
    in-process (2, 2) run's params (a model-yields leaf its worker chunk),
    bitwise; its losses bitwise, its grad norms to NORM_RTOL."""
    cfg = _cfg(CELLS[cell])
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    fd = dict(tree_leaves_with_path(steps.fsdp_dims(cfg, mesh)))
    md = dict(tree_leaves_with_path(steps.fsdp_model_dims(cfg, mesh)))
    glob = in_process["fsdp"][cell]
    for r, out in enumerate(ranks()):
        w, k = (int(c) for c in out["coords"])
        assert (w, k) == (r // 2, r % 2)
        for path, v in glob["params"].items():
            t = torch.from_numpy(v)
            if md[path] >= 0:
                t = t.chunk(2, md[path])[k]
            if fd[path] >= 0:
                t = t.chunk(2, fd[path])[w]
            assert _bits_equal(out[f"{cell}/params/{path}"], t.numpy()), (r, path)
        assert _bits_equal(out[f"{cell}/loss"], glob["loss"])
        np.testing.assert_allclose(out[f"{cell}/grad_norm"], glob["grad_norm"], rtol=NORM_RTOL)
