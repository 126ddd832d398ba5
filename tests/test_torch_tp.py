"""Tensor parallelism in the port (a mesh's ``model`` axis > 1): the
partition rules and ``tp_plan`` (``repro_torch.models.sharding``), the
dry-run specs (``launch/steps.cache_shardings`` / ``input_specs``), the
forward and its gradients on the model shards, the train step and the
trainer over ``make_debug_mesh(data, model)``, 4 gloo ranks at (data 2,
model 2), the refusals and the CLI.

The reference's tensor parallelism is GSPMD: with this jax its embedding
gather raises ``ShardingTypeError`` once the params carry model-axis
shardings, so it is never run at model > 1 here.  The port's model-M runs
are held against the reference at model size 1 (the same function: the
reference's ``ShardCtx`` changes the layout, not the result), against
themselves across processes, and the reference's own failing TP tests'
assertions are rerun on the port.  The reference's specs are pure shape
functions; ``input_specs`` needs a mesh, so it runs once in a subprocess
on 8 forced CPU devices, and its train step once in a subprocess on 4
(replicated params, as tests/test_torch_trainer.py runs it).  At the same
time 4 gloo ranks (spawned once for the module, a ``file://`` rendezvous,
every join with a timeout) run :func:`jobs` on their shards.

Tolerances, stated where used:
- specs, shapes, dtypes and the gathered-leaf table: equal;
- forward logits and loss at in-process model M against the reference's
  model-1 forward, f32: 1e-5 absolute (tests/test_torch_families.py's f32
  tolerance); gradients 1e-5 times max(1, the leaf's largest reference
  gradient);
- the train step at (4, 2) against the reference's (4, 1), f32, 2 SGD
  steps: losses and grad norms 1e-6 relative, params 1e-5 absolute
  (tests/test_torch_trainer.py's); the chunked sketch's cells to one bin
  width a step, held as 1e-3 absolute on the params (SGD 0.5 over
  gradients whose worker range is below 2e-3 a coordinate);
- gloo ranks against the in-process (2, 2) run: bitwise (a sum of two
  partials is the same in either order), params, losses and grad norms.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import sharding as ref_sharding
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.configs import INPUT_SHAPES
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, train, trainer
from repro_torch.models import convert, sharding
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4  # the gloo ranks: (data 2, model 2)
TINY = dict(name="trainer-test-tiny", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=172, vocab=128, dtype="float32")
STEP_DATA = dict(vocab=128, seq_len=16, global_batch=4, num_workers=4, seed=0)
STEPS, SGD_LR = 2, 0.5
FWD_TOL = 1e-5
LOSS_RTOL, PARAM_ATOL, CHUNKED_ATOL = 1e-6, 1e-5, 1e-3
# (d): the five strategies at (4, 2) (hierarchical on (pod 2, data 2, model 2))
STEP_CELLS = {f"{s}_{m}": (s, m) for s in ("gather", "bucketed", "chunked", "hierarchical")
              for m in ("median", "trimmed_mean")}
STEP_CELLS["psum_mean"] = ("psum", "mean")
# (e): (config, dtype, strategy, aggregator, attack) on the gloo ranks
RANK_CELLS = {
    "gather_median_alie": ("tiny", "float32", "gather", "median", "alie"),
    "gather_tm_alie": ("tiny", "float32", "gather", "trimmed_mean", "alie"),
    "gather_median_mimic": ("tiny", "float32", "gather", "median", "mimic"),
    "gather_tm_mimic": ("tiny", "float32", "gather", "trimmed_mean", "mimic"),
    "bucketed_median_alie": ("tiny", "float32", "bucketed", "median", "alie"),
    "bucketed_tm_alie": ("tiny", "float32", "bucketed", "trimmed_mean", "alie"),
    "granite_gather_median_alie": ("granite-moe-1b-a400m", "float32", "gather", "median",
                                   "alie"),
    "qwen3_gather_tm_mimic": ("qwen3-14b", "float32", "gather", "trimmed_mean", "mimic"),
    "llama_bf16_bucketed_median_alie": ("llama3.2-3b", "bfloat16", "bucketed", "median",
                                        "alie"),
    # a row-parallel out-projection after a whole mixer (ssm) and the
    # encoder with cross-attention on each rank's kv heads (audio)
    "mamba2_gather_median_alie": ("mamba2-2.7b", "float32", "gather", "median", "alie"),
    "whisper_gather_tm_alie": ("whisper-small", "float32", "gather", "trimmed_mean", "alie"),
}
RANK_DATA = dict(seq_len=16, global_batch=4, num_workers=2, seed=0)
CLI_ARGS = ["--config", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps", "2",
            "--seq-len", "16", "--global-batch", "4", "--model-par", "2", "--strategy",
            "gather", "--attack", "alie", "--attack-alpha", "0.25"]
# (a): the leaves each configuration gathers (by name), at model 2, 4 and 16
GATHERED = {
    ("granite-moe-1b-a400m", "full"): (("router",),) * 3,
    ("granite-moe-1b-a400m", "smoke"): (("router",), ("router",),
                                        ("router", "wk", "wo", "wq", "wv")),
    ("llama3-405b", "full"): ((),) * 3,
    ("llama3-405b", "smoke"): ((), (), ("wk", "wo", "wq", "wv")),
    ("mamba2-2.7b", "full"): ((),) * 3,
    ("mamba2-2.7b", "smoke"): ((),) * 3,
    ("whisper-small", "full"): ((),) * 3,
    ("whisper-small", "smoke"): ((), (), ("wk", "wo", "wq", "wv")),
    ("recurrentgemma-2b", "full"): ((), ("wk", "wo", "wq", "wv"), ("wk", "wo", "wq", "wv")),
    ("recurrentgemma-2b", "smoke"): ((), ("wk", "wo", "wq", "wv"), ("wk", "wo", "wq", "wv")),
    ("llama3.2-3b", "full"): ((),) * 3,
    ("llama3.2-3b", "smoke"): ((), (), ("wk", "wo", "wq", "wv")),
    ("internvl2-1b", "full"): ((), (), ("wk", "wo", "wq", "wv")),
    ("internvl2-1b", "smoke"): ((), (), ("wk", "wo", "wq", "wv")),
    ("qwen3-14b", "full"): ((),) * 3,
    ("qwen3-14b", "smoke"): ((), ("wk", "wo", "wq", "wv"), ("wk", "wo", "wq", "wv")),
    ("grok-1-314b", "full"): (("router",),) * 3,
    ("grok-1-314b", "smoke"): (("router",), ("router",), ("router", "wk", "wo", "wq", "wv")),
    ("h2o-danube-1.8b", "full"): ((),) * 3,
    ("h2o-danube-1.8b", "smoke"): ((), (), ("wk", "wo", "wq", "wv")),
}
MODELS = (2, 4, 16)
SPEC_MESHES = {"4x2": (4, 2, 0), "2x2x2": (2, 2, 2)}  # (data, model, pod)

RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_tp as T
T.run_rank(int(sys.argv[2]), *sys.argv[3:])
"""

REF_SPECS_SCRIPT = r"""
import json, sys
import jax, numpy as np
from repro.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro.launch import mesh as mesh_lib, steps

out = {}
for mname, (data, model, pod) in json.loads(sys.argv[1]).items():
    mesh = mesh_lib.make_debug_mesh(data, model, pod=pod)
    for arch in ARCHITECTURES:
        cfg = get_config(arch)
        for sname, shape in INPUT_SHAPES.items():
            specs = steps.input_specs(cfg, shape, mesh)
            leaves = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(specs)[0]:
                key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                spec = [list(e) if isinstance(e, tuple) else e for e in tuple(leaf.sharding.spec)]
                leaves[key] = [list(leaf.shape), str(leaf.dtype), spec]
            out[f"{arch}|{sname}|{mname}"] = leaves
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
print("OK")
"""

REF_STEP_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import llama3_2_3b
from repro.configs.base import ParallelConfig, TrainConfig
from repro.core.attacks import AttackConfig
from repro.data.pipeline import DataConfig, make_lm_batch
from repro.launch import mesh as mesh_lib, steps, trainer
from repro.optim.optimizers import get_optimizer

# replicated params: with this jax the embed's model-axis sharding makes the
# gather raise ShardingTypeError even at model size 1
steps.param_shardings = lambda cfg, mesh: jax.tree.map(
    lambda _: NamedSharding(mesh, P()), steps.T.param_shapes(cfg),
    is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))

spec = json.loads(sys.argv[1])
cfg = dataclasses.replace(llama3_2_3b.smoke_config(), **spec["tiny"])
dcfg = DataConfig(**spec["data"])
meshes = {"flat": mesh_lib.make_debug_mesh(4, 1), "pods": mesh_lib.make_debug_mesh(2, 1, pod=2)}
out = {}

def dump(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)

dump("init/", trainer.init_state(cfg, meshes["flat"], get_optimizer("sgd", spec["lr"]),
                                 seed=0)["params"])
for i in range(spec["steps"]):
    b = make_lm_batch(dcfg, i, None)
    out[f"batch/{i}/tokens"] = np.asarray(b["tokens"])
    out[f"batch/{i}/labels"] = np.asarray(b["labels"])
for name, (strategy, method) in spec["cells"].items():
    pcfg = ParallelConfig(agg_method=method, agg_strategy=strategy, agg_beta=0.25, remat=False)
    tcfg = TrainConfig(optimizer="sgd", lr=spec["lr"], steps=spec["steps"], device_steps=1)
    r = trainer.train_loop(cfg, pcfg, tcfg, meshes["pods" if strategy == "hierarchical"
                                                   else "flat"],
                           dcfg=dcfg, attack=AttackConfig("alie", 0.25))
    out[f"{name}/loss"] = np.array([h["loss"] for h in r.history])
    out[f"{name}/grad_norm"] = np.array([h["grad_norm"] for h in r.history])
    dump(f"{name}/params/", r.state["params"])
np.savez(sys.argv[2], **out)
print("OK")
"""


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _tiny():
    return dataclasses.replace(configs.get_smoke_config("llama3.2-3b"), **TINY)


def _rank_cfg(name, dtype):
    cfg = _tiny() if name == "tiny" else configs.get_smoke_config(name)
    return dataclasses.replace(cfg, dtype=dtype)


def _numpy(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        train.main(argv)
    return buf.getvalue()


def _loss_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("step ")]


def jobs(mesh):
    """Every gloo-rank job on ``mesh`` (the in-process (2, 2) debug mesh, or
    a rank of the process group): {name: params tree or tensor}, params
    the global view in process and the rank's shards under the group."""
    out = {}
    for name, (arch, dtype, strategy, method, attack) in RANK_CELLS.items():
        cfg = _rank_cfg(arch, dtype)
        pcfg = ParallelConfig(agg_method=method, agg_strategy=strategy, agg_beta=0.25,
                              attn_chunk=0)
        r = trainer.train_loop(cfg, pcfg, TrainConfig(optimizer="adamw", lr=1e-2, steps=STEPS,
                                                      device_steps=1), mesh,
                               dcfg=pipeline.DataConfig(vocab=cfg.vocab, **RANK_DATA),
                               attack=AttackConfig(attack, 0.5))
        out[f"{name}/params"] = r.state["params"]
        out[f"{name}/loss"] = torch.tensor([h["loss"] for h in r.history])
        out[f"{name}/grad_norm"] = torch.tensor([h["grad_norm"] for h in r.history])
    return out


def _flat(out):
    flat = {}
    for name, v in out.items():
        if torch.is_tensor(v):
            flat[name] = _numpy(v)
        else:
            for path, t in tree_leaves_with_path(v):
                flat[f"{name}/{path}"] = _numpy(t)
    return flat


def run_rank(rank: int, rendezvous: str, outdir: str) -> None:
    """One rank of the module's process group at (data 2, model 2): the
    mesh's layout, :func:`jobs` on this rank's shards and the train CLI
    under ``--mesh single``, outputs to ``outdir``."""
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    mesh = mesh_lib.make_production_mesh(model=2, device="cpu")
    layout = {"shape": mesh_lib.mesh_shape_dict(mesh), "workers": mesh_lib.num_workers(mesh),
              "model_rank": mesh_lib.model_rank(mesh), "coords": mesh.axes.coords,
              "data_group": dist.get_process_group_ranks(mesh.axes.groups[("data",)]),
              "model_group": dist.get_process_group_ranks(mesh.axes.groups[("model",)])}
    flat = _flat(jobs(mesh))
    flat["layout"] = np.array(json.dumps(layout))
    flat["cli"] = np.array(_cli(CLI_ARGS + ["--mesh", "single"]))
    np.savez(f"{outdir}/rank{rank}.npz", **flat)
    dist.destroy_process_group()


def _spawn(cmd, env):
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The reference's two subprocesses and the 4 gloo ranks, started once
    for the module (the in-process tests run while they do)."""
    d = tmp_path_factory.mktemp("tp")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref_env = dict(env, JAX_PLATFORMS="cpu")
    step_spec = {"tiny": TINY, "data": STEP_DATA, "lr": SGD_LR, "steps": STEPS,
                 "cells": {k: list(v) for k, v in STEP_CELLS.items()}}
    started = {
        "specs": _spawn([sys.executable, "-c", REF_SPECS_SCRIPT, json.dumps(SPEC_MESHES),
                         str(d / "specs.json")],
                        dict(ref_env, XLA_FLAGS="--xla_force_host_platform_device_count=8")),
        "step": _spawn([sys.executable, "-c", REF_STEP_SCRIPT, json.dumps(step_spec),
                        str(d / "step.npz")],
                       dict(ref_env, XLA_FLAGS="--xla_force_host_platform_device_count=4")),
    }
    for r in range(WORLD):
        started[f"rank {r}"] = _spawn([sys.executable, "-c", RANK_SCRIPT,
                                       os.path.join(ROOT, "tests"), str(r),
                                       str(d / "rendezvous"), str(d)], env)
    results = {}

    def wait(name):
        if name not in results:
            log = started[name].communicate(timeout=300)[0]
            assert started[name].returncode == 0, f"{name}: {log[-4000:]}"
            results[name] = log
        return d

    yield wait
    for p in started.values():
        p.kill()


@pytest.fixture(scope="module")
def ref_specs(procs):
    with open(procs("specs") / "specs.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref_step(procs):
    return dict(np.load(procs("step") / "step.npz"))


@pytest.fixture(scope="module")
def rank_outs(procs):
    d = None
    for r in range(WORLD):
        d = procs(f"rank {r}")
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def in_process(procs):
    """The gloo jobs over the in-process (2, 2) mesh (run while the ranks do)."""
    return _flat(jobs(mesh_lib.make_debug_mesh(2, 2, device="cpu")))


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                         b.view(np.uint8))


def _nested(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


def _ref_leaves(tree, is_leaf=None):
    import jax

    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _at(tree, path):
    """The entry of a tree (whose leaves may be tuples) at ``path``."""
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _configs(arch, size):
    if size == "smoke":
        return configs.get_smoke_config(arch), ref_get_smoke_config(arch)
    return configs.get_config(arch), ref_get_config(arch)


# ---------------------------------------------------------------------------
# (a) partition specs and the tensor-parallel plan
# ---------------------------------------------------------------------------

VARIANTS = [(a, s) for a in configs.ARCHITECTURES for s in ("full", "smoke")]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("arch,size", VARIANTS, ids=[f"{a}-{s}" for a, s in VARIANTS])
def test_partition_specs_match_the_reference(arch, size, model):
    from jax.sharding import PartitionSpec as P

    cfg, rcfg = _configs(arch, size)
    want = {k: tuple(v) for k, v in _ref_leaves(
        ref_sharding.tree_partition_specs(RT.param_shapes(rcfg), "model", model),
        is_leaf=lambda x: isinstance(x, P)).items()}
    paths = [p for p, _ in tree_leaves_with_path(T.meta_params(cfg))]
    specs = sharding.tree_partition_specs(T.meta_params(cfg), "model", model)
    assert {p: _at(specs, p) for p in paths} == want
    # the port's per-leaf split dim and the trainer's specs agree with them
    dims = dict(tree_leaves_with_path(sharding.tp_dims(cfg, model)))
    assert dims == {k: next((i for i, e in enumerate(v) if e == "model"), -1)
                    for k, v in want.items()}
    mesh = mesh_lib.make_debug_mesh(1, model, device="cpu")
    assert {p: _at(steps.param_shardings(cfg, mesh), p) for p in paths} == want


@pytest.mark.parametrize("arch,size", VARIANTS, ids=[f"{a}-{s}" for a, s in VARIANTS])
def test_tp_plan_lists_the_gathered_leaves(arch, size):
    """``tp_plan``'s gathered leaves at model 2, 4 and 16: the attention
    leaves where the reference replicates the kv heads (2·kv < M: the
    ``gathered`` mode; where kv % M != 0 and 2·kv >= M the ``padded`` mode
    computes on the shards; the encoder and cross groups by the encoder
    config's heads), the MoE
    router wherever it is split, the packed ``w_in`` where the ``ssm``
    mixer's heads do not divide; every other split leaf (the ``ssm`` /
    ``rec`` in-projections of the ``heads`` / ``channels`` modes, the
    row-parallel ``w_out`` / ``w_ro``) computes on its shard, and no mode
    is left unported."""
    cfg, _ = _configs(arch, size)
    enc = dataclasses.replace(cfg, moe=None, qk_norm=False)
    for model, want in zip(MODELS, GATHERED[(arch, size)]):
        plan = sharding.tp_plan(cfg, model)
        gathered = tuple(sorted({p.split("/")[-1] for p, (_, m) in plan.items()
                                 if m == "gathered"}))
        assert gathered == want, (model, gathered)
        assert {m for _, m in plan.values()} <= {"shard", "gathered"}
        dims = dict(tree_leaves_with_path(sharding.tp_dims(cfg, model)))
        assert {p: d for p, (d, _) in plan.items()} == {p: d for p, d in dims.items() if d >= 0}
        modes = sharding.tp_modes(cfg, model)
        for path, (_, mode) in plan.items():
            name = path.split("/")[-1]
            if name in ("w_in", "w_bx", "w_bg", "w_a", "w_xg"):
                assert mode == ("gathered" if modes.ssm == "gathered" else "shard") \
                    and name in modes.mixer_in, (model, path)
            elif name in ("w_out", "w_ro"):
                assert mode == "shard" and name in modes.mixer_out, (model, path)
            elif path.split("/")[0] in ("enc_blocks", "cross_blocks") and name in (
                    "wq", "wk", "wv", "wo"):
                assert (mode == "gathered") == (sharding.tp_modes(enc, model).attn
                                                == "gathered"), (model, path)
        heads = cfg.n_kv_heads % model == 0
        padded = 2 * cfg.n_kv_heads >= model
        assert modes.attn in ((None,) if not modes.attn_split else ("heads",) if heads else
                              ("padded",) if padded else ("gathered",)), (model, modes)


def test_tp_modes_of_the_slice_configurations():
    """The layer modes this slice's tests and phase 20 run."""
    smoke = configs.get_smoke_config
    assert sharding.tp_modes(configs.get_config("llama3.2-3b"), 2) == sharding.TPModes(
        "heads", ("wk", "wo", "wq", "wv"), True, None, None, 0, 1)
    granite = sharding.tp_modes(configs.get_config("granite-moe-1b-a400m"), 2)
    assert (granite.moe, granite.router, granite.embed, granite.lm_head) == ("experts", 1, 1, 0)
    grok = sharding.tp_modes(smoke("grok-1-314b"), 8)
    assert (grok.attn, grok.moe, grok.router) == ("gathered", "hidden", 0)
    assert sharding.tp_modes(smoke("qwen3-14b"), 2).attn == "padded"
    assert sharding.tp_modes(smoke("qwen3-14b"), 4).attn == "gathered"
    assert sharding.tp_modes(smoke("llama3.2-3b"), 1) == sharding.tp_modes(smoke("qwen3-14b"), 1)
    assert sharding.NULL_CTX.model == 1 and sharding.NULL_CTX.ranks() == (0,)


def test_shard_ctx_keeps_the_reference_ok_rule():
    """The port's ``shard_ok`` is the reference's ``ShardCtx._ok``, and its
    ``ShardCtx`` is the identity at model size 1."""
    from repro.models.sharding import ShardCtx as RefCtx

    for shape in ({"data": 4, "model": 2}, {"data": 2, "model": 16}, {"pod": 2, "data": 2,
                                                                        "model": 2}):
        waxes = tuple(a for a in shape if a != "model")
        ref = RefCtx(batch_axes=waxes, model_axes=("model",), mesh_shape=shape)
        for d in (1, 2, 3, 4, 8, 16, 24, 49155):
            for axes in (waxes, ("model",), ()):
                assert sharding.shard_ok(d, axes, shape) == ref._ok(d, axes), (shape, d, axes)
    x = torch.arange(6.0).reshape(2, 3)
    null = sharding.NULL_CTX
    assert (null.model, null.ranks()) == (1, (0,)) and null.modes(
        configs.get_smoke_config("grok-1-314b")) == \
        sharding.tp_modes(configs.get_smoke_config("llama3.2-3b"), 1)
    for out in (null.shard(x, 1, 0), null.split(x, 1, 0), null.enter(x), null.local(x, 0),
                null.full(x, 0), null.reduce([x]), null.cat([x], -1), null.pmax([x])):
        assert out is x


# ---------------------------------------------------------------------------
# (b) the dry-run specs against the reference's on 8 forced devices
# ---------------------------------------------------------------------------


def _port_specs(arch, sname, mname):
    data, model, pod = SPEC_MESHES[mname]
    mesh = mesh_lib.make_debug_mesh(data, model, pod=pod, device="cpu")
    out = {}
    for path, leaf in tree_leaves_with_path(steps.input_specs(
            configs.get_config(arch), INPUT_SHAPES[sname], mesh)):
        spec = [list(e) if isinstance(e, tuple) else e for e in leaf.spec]
        out[path] = [list(leaf.meta.shape), str(leaf.meta.dtype).removeprefix("torch."), spec]
    return out


@pytest.mark.parametrize("mname", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", configs.ARCHITECTURES)
def test_input_specs_and_cache_shardings_match_the_reference(ref_specs, arch, mname):
    """Every input of every shape (train, prefill, decode with its cache
    tree and ``cache_shardings``): shapes, dtypes and specs equal."""
    for sname in INPUT_SHAPES:
        assert _port_specs(arch, sname, mname) == ref_specs[f"{arch}|{sname}|{mname}"], sname


def test_abstract_window_batches_and_state():
    """``abstract_window_batches``: the train inputs with device_steps in
    front, split over the worker axes; ``abstract_state`` at model 2 under
    a process group holds the rank's shard shapes, and they are what
    ``init_state`` cuts."""
    from repro_torch.core import distributed as D

    mesh = mesh_lib.make_debug_mesh(2, 2, pod=2, device="cpu")
    cfg = configs.get_config("whisper-small")
    got = trainer.abstract_window_batches(cfg, INPUT_SHAPES["train_4k"], mesh, 4)
    assert set(got) == {"tokens", "labels", "frontend"}
    assert tuple(got["frontend"].meta.shape) == (4, 256, 1500, 768)
    assert all(v.spec == (None, ("pod", "data")) for v in got.values())
    with pytest.raises(ValueError, match="train shape"):
        trainer.abstract_window_batches(cfg, INPUT_SHAPES["decode_32k"], mesh, 4)
    tiny = _tiny()
    pg = mesh_lib.Mesh(("data", "model"), (2, 2), torch.device("cpu"),
                       D.InProcessAxes({"data": 2, "model": 2}, "cpu"), rank=0, per_rank=True)
    opt = get_optimizer("adamw", 1e-3)
    st = trainer.abstract_state(tiny, pg, opt, ParallelConfig())
    real = trainer.init_state(tiny, pg, opt, seed=0, pcfg=ParallelConfig())
    shapes = [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(st["params"])]
    assert shapes == [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(real["params"])]
    assert dict(shapes)["embed"] == (64, 64) and dict(shapes)["lm_head"] == (64, 64)
    assert dict(shapes)["blocks/p0_attn/wq"] == (1, 64, 32) and dict(shapes)["final_norm"] == (64,)


# ---------------------------------------------------------------------------
# (c) the forward and its gradients on the shards against the reference
# ---------------------------------------------------------------------------

FORWARD = [("llama3.2-3b", 2, {}), ("qwen3-14b", 2, {}), ("h2o-danube-1.8b", 2, {}),
           ("llama3-405b", 2, {}), ("granite-moe-1b-a400m", 2, {}),
           ("granite-moe-1b-a400m", 2, {"vocab": 257}), ("grok-1-314b", 8, {}),
           ("mamba2-2.7b", 2, {}), ("mamba2-2.7b", 4, {}),
           ("recurrentgemma-2b", 2, {}), ("recurrentgemma-2b", 4, {}),
           ("whisper-small", 2, {}), ("whisper-small", 4, {}),
           ("whisper-small", 2, {"vocab": 257}),
           ("internvl2-1b", 2, {}), ("internvl2-1b", 4, {}),
           ("internvl2-1b", 2, {"vocab": 257})]
FORWARD_IDS = ["llama3.2", "qwen3-gathered", "danube", "llama3-405b", "granite-experts",
               "granite-dsplit", "grok-m8-hidden-gathered", "mamba2-ssm", "mamba2-m4",
               "recurrentgemma-rec", "recurrentgemma-m4", "whisper-audio-heads",
               "whisper-m4-heads", "whisper-dsplit", "internvl2-vision-heads",
               "internvl2-m4-gathered", "internvl2-dsplit"]


@pytest.mark.parametrize("arch,model,over", FORWARD, ids=FORWARD_IDS)
def test_forward_and_gradients_on_the_shards_match_the_reference(arch, model, over):
    """In-process model M (every rank of a layer in turn, from chunks of the
    global view) against the reference's model-1 forward, f32: logits,
    aux, loss and every gradient leaf.  granite with vocab 257 (odd, as
    its published 49155) splits embed and lm_head on d_model, as do
    whisper and internvl2 at 257 (their published 51865 and 151655 are
    odd); grok-smoke's 4 experts cannot split 8 ways (its experts split on
    F) and its kv = 2 heads are gathered.  mamba2 and recurrentgemma run
    their mixers from gathered in-projections with row-parallel
    out-projections; whisper's encoder and cross-attention split on their
    kv heads (one a rank at model 4), internvl2's patch prefix rides the
    whole embedding (its kv = 2 heads gathered at model 4).  The frontend
    (frames or patches, f32 standard normals) goes to both packages."""
    import jax
    import jax.numpy as jnp

    over = dict(over, dtype="float32")
    rc = dataclasses.replace(ref_get_smoke_config(arch), **over)
    pc = dataclasses.replace(configs.get_smoke_config(arch), **over)
    rp = RT.init_params(rc, jax.random.PRNGKey(0))
    pp = convert.transformer_from_reference(pc, jax.tree.map(np.asarray, rp), device="cpu")
    ctx = sharding.model_ctx(mesh_lib.make_debug_mesh(1, model, device="cpu"))
    assert ctx.model == model
    rng_ = np.random.default_rng(7)
    tok = rng_.integers(0, rc.vocab, (2, 12)).astype(np.int32)
    lab = rng_.integers(0, rc.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": tok, "labels": lab}
    if pc.frontend != "none":
        batch["frontend"] = rng_.standard_normal((2, pc.n_frontend_tokens, pc.d_model)).astype(
            np.float32)
    rfe = jnp.asarray(batch["frontend"]) if "frontend" in batch else None
    pfe = torch.from_numpy(batch["frontend"]) if "frontend" in batch else None
    want, want_aux = RT.forward(rp, jnp.asarray(tok), rc, frontend=rfe, remat=False, kv_block=0)
    got, aux = T.forward(pp, torch.from_numpy(tok), pc, frontend=pfe, kv_block=0, ctx=ctx)
    np.testing.assert_allclose(_numpy(got), np.asarray(want), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=FWD_TOL, rtol=0)
    rloss, rgrad = jax.value_and_grad(
        lambda p: RT.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
                             remat=False, kv_block=0))(rp)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(pp)]
    it = iter(leaves)
    req = tree_map(lambda _: next(it), pp)
    loss = T.loss_fn(req, {k: torch.from_numpy(v) for k, v in batch.items()}, pc, kv_block=0,
                     ctx=ctx)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), atol=FWD_TOL, rtol=0)
    # whisper's cross FFN leaves are read by no computation: exactly 0, as JAX gives
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    want_g = _ref_leaves(rgrad)
    for (path, _), g in zip(tree_leaves_with_path(pp), grads):
        w = np.asarray(want_g[path])
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_numpy(g), w, atol=FWD_TOL * scale, rtol=0, err_msg=path)


def test_model_one_is_the_null_context():
    """make_debug_mesh(data, 1) runs the forward with NULL_CTX: the bits of
    a forward with no context."""
    cfg = dataclasses.replace(configs.get_smoke_config("granite-moe-1b-a400m"), dtype="float32")
    params = T.init_params(cfg, 0, "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)))
    assert sharding.model_ctx(mesh_lib.make_debug_mesh(4, 1, device="cpu")) is sharding.NULL_CTX
    a, _ = T.forward(params, tok, cfg, kv_block=0)
    b, _ = T.forward(params, tok, cfg, kv_block=0, ctx=sharding.NULL_CTX)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch,model", [("llama3.2-3b", 2), ("granite-moe-1b-a400m", 2),
                                        ("grok-1-314b", 8)], ids=["llama3.2", "granite", "grok"])
def test_reference_params_carry_to_a_rank_s_shards(arch, model):
    """The reference's params reach model rank k's TP shards through
    ``convert.transformer_from_reference`` then ``steps.tp_shard``: each
    leaf is chunk k of the reference's array along its ``PartitionSpec``'s
    model dim (bitwise), in the shapes ``abstract_params`` gives a rank."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro_torch.core import distributed as D

    rc, pc = ref_get_smoke_config(arch), configs.get_smoke_config(arch)
    rp = jax.tree.map(np.asarray, RT.init_params(rc, jax.random.PRNGKey(0)))
    full = convert.transformer_from_reference(pc, rp, device="cpu")
    ref_specs = _ref_leaves(ref_sharding.tree_partition_specs(rp, "model", model),
                            is_leaf=lambda x: isinstance(x, P))
    ref_np = _ref_leaves(rp)
    specs = sharding.tree_partition_specs(T.meta_params(pc), "model", model)
    pg = mesh_lib.Mesh(("data", "model"), (1, model), torch.device("cpu"),
                       D.InProcessAxes({"data": 1, "model": model}, "cpu"), rank=0, per_rank=True)
    meta = dict(tree_leaves_with_path(steps.abstract_params(pc, pg)))
    for k in range(model):
        got = dict(tree_leaves_with_path(steps.tp_shard(full, specs, k, model)))
        assert got.keys() == ref_np.keys()
        for path, t in got.items():
            want = ref_np[path]
            d = next((i for i, e in enumerate(ref_specs[path]) if e == "model"), None)
            if d is not None:
                want = np.split(want, model, axis=d)[k]
            assert tuple(t.shape) == tuple(meta[path].shape) == want.shape, path
            assert np.array_equal(_numpy(t), want.astype(np.float32)), (k, path)


# ---------------------------------------------------------------------------
# (d) the train step at (4, 2) against the reference's (4, 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(STEP_CELLS))
def test_train_step_at_model_two_matches_the_reference(ref_step, cell):
    """2 SGD steps of the tiny llama under alie alpha 0.25 from the
    reference's params on its batches: the port's window at (4, 2)
    ((pod 2, data 2, model 2) for hierarchical) against the reference's at
    model 1.  SGD, because AdamW turns a last-bit difference of a median
    near 0 into a move of lr (tests/test_torch_trainer.py)."""
    strategy, method = STEP_CELLS[cell]
    cfg = _tiny()
    mesh = (mesh_lib.make_debug_mesh(2, 2, pod=2, device="cpu") if strategy == "hierarchical"
            else mesh_lib.make_debug_mesh(4, 2, device="cpu"))
    pcfg = ParallelConfig(agg_method=method, agg_strategy=strategy, agg_beta=0.25, remat=False)
    opt = get_optimizer("sgd", SGD_LR)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    state["params"] = convert.transformer_from_reference(cfg, _nested(ref_step, "init/"), "cpu")
    state["opt_state"] = opt.init(state["params"])
    window = trainer.make_window_step(cfg, pcfg, mesh, opt, AttackConfig("alie", 0.25), 1)
    losses, norms = [], []
    for i in range(STEPS):
        before = {k: float(v) for k, v in state["metrics"].items()}
        batch = {k: torch.from_numpy(ref_step[f"batch/{i}/{k}"])[None]
                 for k in ("tokens", "labels")}
        state = window(state, batch)
        met = trainer.window_metrics(before, state)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
    np.testing.assert_allclose(losses, ref_step[f"{cell}/loss"], rtol=LOSS_RTOL)
    atol = CHUNKED_ATOL if strategy == "chunked" else PARAM_ATOL
    if strategy != "chunked":
        np.testing.assert_allclose(norms, ref_step[f"{cell}/grad_norm"], rtol=LOSS_RTOL)
    want = _nested(ref_step, f"{cell}/params/")
    for path, t in tree_leaves_with_path(state["params"]):
        w = want
        for p in path.split("/"):
            w = w[p]
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=atol, err_msg=path)
    assert not np.array_equal(state["params"]["embed"].numpy(), _nested(ref_step,
                                                                        "init/")["embed"])


# ---------------------------------------------------------------------------
# (e) 4 gloo ranks at (data 2, model 2) against the in-process (2, 2) run
# ---------------------------------------------------------------------------


def test_the_process_group_lays_out_data_by_model(rank_outs):
    """Ranks row-major over (data, model): rank r is worker r // 2, model
    rank r % 2; the worker-axis groups are the ranks of one model
    coordinate, the model groups a worker's two ranks."""
    for r, out in enumerate(rank_outs):
        lay = json.loads(str(out["layout"]))
        assert lay["shape"] == {"data": 2, "model": 2} and lay["workers"] == 2
        assert lay["coords"] == {"data": r // 2, "model": r % 2} and lay["model_rank"] == r % 2
        assert lay["data_group"] == [r % 2, r % 2 + 2]
        assert lay["model_group"] == [r - r % 2, r - r % 2 + 1]


@pytest.mark.parametrize("cell", list(RANK_CELLS))
def test_gloo_ranks_are_bitwise_the_in_process_run(rank_outs, in_process, cell):
    """Each rank's params after 2 AdamW steps are bitwise its chunk of the
    in-process (2, 2) global view (replicated leaves whole); the losses
    and grad norms bitwise too (a psum over two model ranks adds one pair,
    in either order the same)."""
    arch, dtype = RANK_CELLS[cell][:2]
    dims = dict(tree_leaves_with_path(sharding.tp_dims(_rank_cfg(arch, dtype), 2)))
    prefix = f"{cell}/params/"
    keys = [k for k in in_process if k.startswith(prefix)]
    assert len(keys) == len(dims)
    for r, out in enumerate(rank_outs):
        for key in keys:
            d = dims[key[len(prefix):]]
            want = in_process[key] if d < 0 else np.split(in_process[key], 2, axis=d)[r % 2]
            assert _bits_equal(out[key], want), (r, key)
        for what in ("loss", "grad_norm"):
            assert _bits_equal(out[f"{cell}/{what}"], in_process[f"{cell}/{what}"]), (r, what)


def test_the_train_cli_under_the_process_group(rank_outs):
    """(h) ``--mesh single --model-par 2`` on the 4 gloo ranks: rank 0
    prints the mesh and the loss lines of ``--mesh debug --workers 2
    --model-par 2``, the other ranks nothing."""
    here = _cli(CLI_ARGS + ["--workers", "2"])
    assert "mesh={'data': 2, 'model': 2} workers=2" in here
    got = str(rank_outs[0]["cli"])
    assert "mesh={'data': 2, 'model': 2} workers=2" in got
    assert _loss_lines(got) == _loss_lines(here) and len(_loss_lines(here)) == STEPS
    assert all(str(out["cli"]) == "" for out in rank_outs[1:])


# ---------------------------------------------------------------------------
# (f) the reference's TP tests' own assertions, on the port at (4, 2)
# ---------------------------------------------------------------------------


def _tp_train_step(cfg, pcfg, opt, attack, dcfg, n_steps):
    mesh = mesh_lib.make_debug_mesh(4, 2, device="cpu")
    params = T.init_params(cfg, 0, "cpu")
    state = opt.init(params)
    fn = steps.make_train_step(cfg, pcfg, mesh, opt, attack)
    losses = []
    for i in range(n_steps):
        params, state, metrics = fn(params, state, pipeline.make_lm_batch(dcfg, i, attack,
                                                                          device="cpu"), i)
        losses.append(float(metrics["loss"]))
    return params, losses


def test_end_to_end_train_step_robustness_at_model_two():
    """tests/test_distributed.py::test_end_to_end_train_step_robustness on
    the port's (4, 2) mesh: median training stays stable under a sign-flip
    Byzantine worker while mean training diverges from the clean run."""
    cfg = configs.get_smoke_config("llama3.2-3b")
    atk = AttackConfig("sign_flip", alpha=0.25, scale=5.0)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, num_workers=4)

    def run(method, attack):
        pcfg = ParallelConfig(agg_method=method, agg_strategy="gather", remat=False,
                              attn_chunk=0)
        return _tp_train_step(cfg, pcfg, get_optimizer("adamw", 2e-3), attack, dcfg, 8)[1]

    clean, med_atk, mean_atk = run("mean", None), run("median", atk), run("mean", atk)
    assert med_atk[-1] < clean[0], (med_atk, clean)
    assert mean_atk[-1] > med_atk[-1] - 1e-3
    assert abs(med_atk[-1] - clean[-1]) < abs(mean_atk[-1] - clean[-1]) + 0.5


def test_bucketed_strategy_in_train_step_at_model_two():
    """tests/test_distributed.py::test_bucketed_strategy_in_train_step on the
    port's (4, 2) mesh: granite-moe (expert-parallel at model 2), gather
    and bucketed medians give the same update (the reference's tolerance;
    here they agree bit for bit)."""
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, num_workers=4)
    outs = {}
    for strat in ("gather", "bucketed"):
        pcfg = ParallelConfig(agg_method="median", agg_strategy=strat, remat=False, attn_chunk=0)
        params, losses = _tp_train_step(cfg, pcfg, get_optimizer("sgd", 1e-2), None, dcfg, 1)
        outs[strat] = (tree_leaves(params)[0], losses[0], params)
    np.testing.assert_allclose(_numpy(outs["gather"][0]), _numpy(outs["bucketed"][0]),
                               rtol=2e-2, atol=1e-4)
    assert abs(outs["gather"][1] - outs["bucketed"][1]) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(outs["gather"][2]),
                                                 tree_leaves(outs["bucketed"][2])))


def test_train_step_local_rounds_still_learn_at_model_two():
    """tests/test_rounds.py::test_train_step_local_rounds_still_learn on the
    port's (4, 2) mesh: local_steps=4 still reduces the loss."""
    cfg = configs.get_smoke_config("llama3.2-3b")
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, num_workers=4)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", remat=False,
                          attn_chunk=0, local_steps=4, local_lr=5e-3)
    losses = _tp_train_step(cfg, pcfg, get_optimizer("adamw", 2e-3), None, dcfg, 6)[1]
    assert losses[-1] < losses[0], losses


def test_leaf_global_attack_sums_cover_every_model_shard():
    """mimic's per-row sums at model 2 are the whole leaf's: in process the
    chunks' sums added in rank order, equal (to rounding) to the sum over
    the whole leaf, so the replayed row is the one model 1 picks."""
    from repro_torch.core import distributed as D

    rows = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 6, 8))
                            .astype(np.float32))
    ax = D.InProcessAxes({"data": 4, "model": 2}, "cpu")
    for dim in (0, 1):
        got = ax.leaf_row_sum(rows, dim)
        want = sum(c.reshape(4, -1).sum(1) for c in rows.chunk(2, 1 + dim))
        assert torch.equal(got, want)
        torch.testing.assert_close(got, rows.reshape(4, -1).sum(1), rtol=1e-6, atol=1e-6)
    assert torch.equal(ax.leaf_row_sum(rows, -1), rows.reshape(4, -1).sum(1))


# ---------------------------------------------------------------------------
# (g) the refusals, each naming its ROADMAP item
# ---------------------------------------------------------------------------


def test_the_model_axis_refusals():
    """What the model axis does not run names its ROADMAP step; every
    configuration trains on it (the ssm / rec families and the frontends
    since step 6), fsdp, seq_parallel, the codecs and randomized attacks
    build and run a step there (step 7), and a frontend configuration's
    serving entry points run there too (step 8); the reference's own
    refusals stay."""
    tp = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    cfg, opt = _tiny(), get_optimizer("adamw", 1e-3)
    smoke = configs.get_smoke_config
    for arch in ("mamba2-2.7b", "recurrentgemma-2b", "whisper-small", "internvl2-1b"):
        steps.make_step_body(smoke(arch), ParallelConfig(), tp, opt)
        c = smoke(arch)
        fe = (None if c.frontend == "none" else
              torch.zeros((1, c.n_frontend_tokens, c.d_model), dtype=getattr(torch, c.dtype)))
        logits, _ = T.forward(T.init_params(c, 0, "cpu"), torch.zeros((1, 4), dtype=torch.long),
                              c, frontend=fe, ctx=sharding.model_ctx(tp))
        assert logits.shape == (1, 4, c.vocab) and bool(torch.isfinite(logits).all())
        if fe is not None:  # step 8: their serving steps run at model 2
            logits, _ = T.prefill(T.init_params(c, 0, "cpu"), torch.zeros((1, 4), dtype=torch.long),
                                  c, frontend=fe, ctx=sharding.model_ctx(tp))
            assert logits.shape == (1, 1, c.vocab) and bool(torch.isfinite(logits).all())
            steps.make_decode_step(c, tp)
    # step 7 is ported: each builds and runs a step at (2, 2), its loss and
    # params finite
    params = T.init_params(cfg, 0, "cpu")
    batch = {k: v for k, v in pipeline.make_lm_batch(
        pipeline.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, num_workers=2,
                            seed=0), 0, None, device="cpu").items() if k in ("tokens", "labels")}
    for pcfg, attack in ((ParallelConfig(param_mode="fsdp"), AttackConfig("alie", 0.25)),
                         (ParallelConfig(seq_parallel=True), AttackConfig("alie", 0.25)),
                         (ParallelConfig(compression="int8"), None),
                         (ParallelConfig(compression="count_sketch"), None),
                         (ParallelConfig(), AttackConfig("gauss", 0.25))):
        step = steps.make_train_step(cfg, pcfg, tp, opt, attack)
        new, _, met = step(params, opt.init(params), batch, 0)
        assert bool(torch.isfinite(met["loss"])) and bool(torch.isfinite(met["grad_norm"]))
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
    sb = steps.make_step_body(cfg, ParallelConfig(compression="topk"), tp, opt)
    assert sb.comp_body is not None
    steps.make_step_body(cfg, ParallelConfig(), tp, opt, AttackConfig("random_label", 0.25))
    # the reference's own refusals, at model 2 as at model 1
    for pcfg, attack, match in (
            (ParallelConfig(param_mode="fsdp", compression="int8"), None, "compression"),
            (ParallelConfig(param_mode="fsdp"), AttackConfig("gauss", 0.25), "randomized"),
            (ParallelConfig(param_mode="fsdp", local_steps=2), None, "local_steps"),
            (ParallelConfig(), AttackConfig("stale", 0.25), "adaptive")):
        with pytest.raises(ValueError, match=match):
            steps.make_step_body(cfg, pcfg, tp, opt, attack)
    with pytest.raises(ValueError, match="whole buckets"):
        steps.make_step_body(cfg, ParallelConfig(agg_strategy="bucketed"), tp, opt,
                             AttackConfig("mimic", 0.25))
    with pytest.raises(ValueError, match="whole buckets"):  # fsdp's reduce-scatter
        steps.make_step_body(cfg, ParallelConfig(param_mode="fsdp"), tp, opt,
                             AttackConfig("mimic", 0.25))
    steps.make_step_body(cfg, ParallelConfig(agg_strategy="gather"), tp, opt,
                         AttackConfig("mimic", 0.25))
    # serving (step 5) is ported: the steps, the engine and the CLI run at
    # model 2, and serve what model 1 serves
    from repro_torch.serve import run as serve_run
    from repro_torch.serve.engine import ServeConfig, ServeEngine, serve_stream
    from repro_torch.serve.traffic import TrafficConfig, VirtualUsers

    params = T.init_params(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(0))
    logits, cache = steps.make_prefill_step(cfg, mesh=tp, cache_len=12)(params, tokens)
    want, want_cache = steps.make_prefill_step(cfg, cache_len=12)(params, tokens)
    torch.testing.assert_close(logits, want, rtol=0, atol=FWD_TOL)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True)
    got = steps.make_decode_step(cfg, tp)(params, tok, cache, 8)[0]
    torch.testing.assert_close(got, steps.make_decode_step(cfg)(params, tok, want_cache, 8)[0],
                               rtol=0, atol=FWD_TOL)
    steps.make_slot_prefill_step(cfg, 16, tp)
    steps.make_decode_pool_step(cfg, tp)
    scfg = ServeConfig(slots=2, prompt_len=8, max_new=4)
    reqs = VirtualUsers(TrafficConfig(num_users=16, num_shards=2, prompt_len=8, min_gen=1,
                                      max_gen=4, vocab=cfg.vocab)).sample_requests(4)
    served = {model: {c.request.rid: c.response.tolist() for c in serve_stream(
        ServeEngine(cfg, scfg, params, mesh_lib.make_debug_mesh(2, model, device="cpu")),
        reqs)} for model in (1, 2)}
    assert served[2] == served[1] and len(served[2]) == 4
    assert serve_run.main(["--device", "cpu", "--smoke", "--model-par", "2", "--requests", "4",
                           "--adapt-every", "0"]) == 0
    for arch in ("mamba2-2.7b", "recurrentgemma-2b"):  # step 6: the ssm / rec layers serve
        steps.make_decode_pool_step(smoke(arch), tp)
        steps.make_slot_prefill_step(smoke(arch), 16, tp)


# ---------------------------------------------------------------------------
# (h) the train CLI on the debug mesh
# ---------------------------------------------------------------------------


def test_the_train_cli_trains_at_model_two():
    text = _cli(["--config", "llama3.2-3b", "--smoke", "--model-par", "2", "--device", "cpu",
                 "--steps", "2", "--seq-len", "16", "--global-batch", "4"])
    assert "mesh={'data': 4, 'model': 2} workers=4" in text
    losses = [float(ln.split()[3]) for ln in _loss_lines(text)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: 2 steps" in text


@pytest.mark.parametrize("extra", [["--compression", "int8"],
                                   ["--attack", "gauss", "--attack-alpha", "0.25"]],
                         ids=["int8", "gauss"])
def test_the_train_cli_runs_codecs_and_randomized_attacks_at_model_two(extra):
    """``--compression`` and a randomized ``--attack`` run at ``--model-par
    2`` (ROADMAP item 6, step 7)."""
    text = _cli(["--config", "llama3.2-3b", "--smoke", "--model-par", "2", "--device", "cpu",
                 "--steps", "2", "--seq-len", "16", "--global-batch", "4"] + extra)
    assert "mesh={'data': 4, 'model': 2} workers=4" in text
    losses = [float(ln.split()[3]) for ln in _loss_lines(text)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: 2 steps" in text
