"""FSDP in the port (``param_mode='fsdp'``): the parameter partition rules
(``repro_torch.models.sharding``), the FSDP dims and specs of
``launch/steps.py``, the robust parameter gather whose backward is the
robust reduce-scatter (``core/distributed.make_robust_param_gather_dim``),
the fsdp step, window and ``train_loop`` (the tiny llama; whisper's
unused leaves; one step of the hybrid, MoE and SSM smoke configs) and
``trainer.abstract_state``, on the in-process debug mesh and on 4 gloo
ranks, against the reference.

The partition specs and FSDP dims are pure shape functions: the reference's
are computed in this process (its ``fsdp_dims`` reads only a mesh's axis
names and sizes, so a stand-in mesh object serves).  The reference's
shard_map programs run once, in a subprocess on 4 forced CPU devices (its
own tests' harness): the gather's backward on tests/test_distributed.py's
case (an (8, 3) weight, 4 workers, loss sum((x_w @ w)^2)) and on exact
integer data, and its fsdp train step on ``make_debug_mesh(4, 1)`` with the
model-axis entries taken out of ``fsdp_param_shardings``' specs and
replicated ``param_shardings`` (with them, this jax's embedding gather
raises ``ShardingTypeError`` even at model size 1; the dims are kept, so it
is the same program).  At the same time 4 gloo ranks (spawned once for the
module, a ``file://`` rendezvous, every join with a timeout) run
:func:`jobs` on their shards and save them.

Tolerances, stated where used:
- the gather's backward on integer data (every product and sum exact in
  f32): bitwise, in process and on every rank; on tests/test_distributed.py's
  normal data that test's own 1e-4 relative + 1e-5 absolute against the
  numpy median (the two packages round the per-worker gradients
  differently);
- the tiny llama's fsdp trajectory against the reference (3 steps): losses
  and grad norms within 1e-6 relative, params within 1e-5 absolute
  (tests/test_torch_trainer.py's LOSS_RTOL and PARAM_ATOL).  It steps with
  SGD, as that file's order-statistic cells under attack do: AdamW moves a
  coordinate by about lr·sign(g), so a median that cancels to near 0 turns
  a last-bit difference of the packages' gradients into a difference of
  order lr (read: 9.2e-4 in the params and 1.4e-5 in the third grad norm
  with AdamW 1e-2);
- within the port (fsdp against replicated, ranks against the in-process
  global view, make_train_step against the window): bitwise, AdamW; grad
  norms under the process group to 1e-6 relative (a backend SUM).
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch import steps as ref_steps
from repro.models import sharding as ref_sharding
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import distributed as D
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, trainer
from repro_torch.models import convert, sharding
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, get_optimizer
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TINY = dict(name="trainer-test-tiny", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=172, vocab=128, dtype="float32")
DATA = dict(vocab=128, seq_len=16, global_batch=4, num_workers=WORLD, seed=0)
STEPS = 3
SGD_LR, ADAMW_LR = 0.5, 1e-2
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
# (aggregator, beta, attack) of the fsdp-against-replicated cells
CELLS = {"median_signflip": ("median", 0.1, "sign_flip"),
         "tm_alie": ("trimmed_mean", 0.25, "alie")}
# name -> (weight shape, FSDP dim, aggregator, beta, integer data)
GATHER = {"median": ((8, 3), 0, "median", 0.1, True),
          "trimmed_mean": ((8, 3), 0, "trimmed_mean", 0.25, True),
          "median_dim1": ((3, 8), 1, "median", 0.1, True),
          "median_normal": ((8, 3), 0, "median", 0.1, False)}
CROSS_FFN = ("ln2", "wd", "wg", "wu")  # cross blocks' leaves no computation reads
# the hybrid tail, the MoE experts and the SSM's float32 leaves in a bf16 model
FAMILIES = ("recurrentgemma-2b", "granite-moe-1b-a400m", "mamba2-2.7b")
RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_fsdp as T
T.run_rank(int(sys.argv[2]), *sys.argv[3:])
"""

REF_SCRIPT = r"""
import dataclasses, functools, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import llama3_2_3b
from repro.configs.base import ParallelConfig, TrainConfig
from repro.core import distributed
from repro.core.attacks import AttackConfig
from repro.data.pipeline import DataConfig, make_lm_batch
from repro.launch import mesh as mesh_lib, steps, trainer
from repro.optim.optimizers import get_optimizer

spec = json.loads(sys.argv[1])
data = dict(np.load(sys.argv[2]))
out = {}

def dump(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)

# the gather's backward over 4 workers: loss sum((x_w @ w)^2), the shards'
# gradients concatenated along the FSDP dim
mesh4 = jax.make_mesh((4,), ("data",))
for name, (shape, dim, method, beta, _) in spec["gather"].items():
    gather = distributed.make_robust_param_gather_dim(("data",), dim, method, beta)
    wspec = P(*[("data" if d == dim else None) for d in range(2)])

    @functools.partial(jax.shard_map, mesh=mesh4, in_specs=(wspec, P("data")), out_specs=wspec,
                       axis_names={"data"}, check_vma=False)
    def grads(w_shard, x):
        return jax.grad(lambda ws: jnp.sum((x[0] @ gather(ws)) ** 2))(w_shard)

    out[f"gather/{name}"] = np.asarray(grads(jnp.asarray(data[f"{name}/w"]),
                                             jnp.asarray(data[f"{name}/x"])))

# the fsdp train step: model-axis entries out of the specs (with them the
# embedding gather raises ShardingTypeError in this jax), dims kept
real = steps.fsdp_param_shardings
def no_model(cfg, mesh):
    shard, dims = real(cfg, mesh)
    strip = lambda s: NamedSharding(mesh, P(*[None if e == "model" else e for e in s.spec]))
    return jax.tree.map(strip, shard, is_leaf=lambda x: isinstance(x, NamedSharding)), dims
steps.fsdp_param_shardings = no_model
steps.param_shardings = lambda cfg, mesh: jax.tree.map(
    lambda _: NamedSharding(mesh, P()), steps.T.param_shapes(cfg),
    is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
cfg = dataclasses.replace(llama3_2_3b.smoke_config(), **spec["tiny"])
mesh = mesh_lib.make_debug_mesh(4, 1)
dcfg = DataConfig(**spec["data"])
dump("init/", trainer.init_state(cfg, mesh, get_optimizer("sgd", spec["lr"]), seed=0)["params"])
for i in range(spec["steps"]):
    b = make_lm_batch(dcfg, i, None)
    out[f"batch/{i}/tokens"] = np.asarray(b["tokens"])
    out[f"batch/{i}/labels"] = np.asarray(b["labels"])
pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", param_mode="fsdp",
                      remat=False)
tcfg = TrainConfig(optimizer="sgd", lr=spec["lr"], steps=spec["steps"], device_steps=1)
r = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=AttackConfig("sign_flip", 0.25))
out["fsdp/loss"] = np.array([h["loss"] for h in r.history])
out["fsdp/grad_norm"] = np.array([h["grad_norm"] for h in r.history])
dump("fsdp/params/", r.state["params"])
np.savez(sys.argv[3], **out)
print("OK")
"""


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _tiny():
    return dataclasses.replace(configs.get_smoke_config("llama3.2-3b"), **TINY)


def _pcfg(method="median", beta=0.1, mode="fsdp"):
    return ParallelConfig(agg_method=method, agg_strategy="gather", agg_beta=beta,
                          param_mode=mode, remat=False)


def _gather_inputs():
    """{case/w, case/x}: the full weight and the 4 workers' inputs (x_w (6,
    rows of w)); integer cases draw small integers (exact arithmetic), the
    normal case tests/test_distributed.py's standard normals."""
    out = {}
    for name, (shape, _, _, _, exact) in GATHER.items():
        rw, rx = np.random.default_rng(4), np.random.default_rng(5)
        if exact:
            out[f"{name}/w"] = rw.integers(-3, 4, shape).astype(np.float32)
            out[f"{name}/x"] = rx.integers(-3, 4, (WORLD, 6, shape[0])).astype(np.float32)
        else:
            out[f"{name}/w"] = rw.standard_normal(shape).astype(np.float32)
            out[f"{name}/x"] = rx.standard_normal((WORLD, 6, shape[0])).astype(np.float32)
    return out


def _gather_grads(ax, name, data, take):
    """The gradient of sum((x_w @ gather(shard))^2) with respect to each
    worker's shard: worker-stacked in process, this rank's under a process
    group."""
    shape, dim, method, beta, _ = GATHER[name]
    w = torch.from_numpy(data[f"{name}/w"])
    shard = take(torch.stack(w.chunk(WORLD, dim))).clone().requires_grad_(True)
    gather = D.make_robust_param_gather_dim(ax, ("data",), dim, method, beta)
    x = take(torch.from_numpy(data[f"{name}/x"]))
    (g,) = torch.autograd.grad(((x @ gather(shard)) ** 2).sum(), shard)
    return g


def _train(mesh, method, beta, attack, mode="fsdp", optim="adamw", steps_n=STEPS):
    lr = ADAMW_LR if optim == "adamw" else SGD_LR
    return trainer.train_loop(_tiny(), _pcfg(method, beta, mode),
                              TrainConfig(optimizer=optim, lr=lr, steps=steps_n, device_steps=1),
                              mesh, dcfg=pipeline.DataConfig(**DATA),
                              attack=AttackConfig(attack, 0.25))


def _family_step(mesh, arch, mode="fsdp"):
    """One AdamW step of ``arch``'s smoke config, gather median under
    sign_flip: the final params."""
    cfg = configs.get_smoke_config(arch)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=4, num_workers=WORLD,
                               seed=0)
    pcfg = ParallelConfig(param_mode=mode, agg_method="median", attn_chunk=0)
    return trainer.train_loop(cfg, pcfg, TrainConfig(optimizer="adamw", lr=1e-3, steps=1,
                                                     device_steps=1),
                              mesh, dcfg=dcfg, attack=AttackConfig("sign_flip", 0.25)
                              ).state["params"]


def _recording(opt):
    """(optimizer, list): the optimizer, appending every aggregate it is
    handed to the list."""
    seen = []

    def update(grads, state, params, step):
        seen.append(grads)
        return opt.update(grads, state, params, step)

    return Optimizer(opt.init, update), seen


def _whisper_aggregate(mesh):
    """One fsdp step of whisper-smoke (gather median, no attack) through
    ``make_train_step``: the aggregate the optimizer got (shards under a
    process group, the global view in process)."""
    cfg = configs.get_smoke_config("whisper-small")
    pcfg = _pcfg()
    opt, seen = _recording(get_optimizer("sgd", 0.1))
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4,
                               num_workers=WORLD, seed=0)
    batch = {k: v[0] for k, v in trainer.stack_window_batches(dcfg, 0, 1, mesh, None,
                                                              cfg).items()}
    step = steps.make_train_step(cfg, pcfg, mesh, opt)
    step(state["params"], state["opt_state"], batch, 0)
    return seen[0]


def _shape_tree(tree):
    return [(p, tuple(t.shape), t.dtype) for p, t in tree_leaves_with_path(tree)]


def jobs(mesh, data):
    """Every fsdp job on ``mesh``: {name: tree or tensor}.  In process the
    param trees are the global view; under a process group this rank's
    shards."""
    ax = mesh.axes
    rank = mesh.rank if mesh.per_rank else None

    def take(x):
        return x if rank is None else x[rank]

    out = {f"gather/{name}": _gather_grads(ax, name, data, take) for name in GATHER}
    for cell, (method, beta, attack) in CELLS.items():
        r = _train(mesh, method, beta, attack)
        out[f"{cell}/params"] = r.state["params"]
        out[f"{cell}/loss"] = torch.tensor([h["loss"] for h in r.history])
        out[f"{cell}/grad_norm"] = torch.tensor([h["grad_norm"] for h in r.history])
    # make_train_step from init_state: the window's params, bit for bit
    cfg, pcfg = _tiny(), _pcfg()
    opt = get_optimizer("adamw", ADAMW_LR)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    out["abstract_state_shapes_match"] = torch.tensor(
        _shape_tree(trainer.abstract_state(cfg, mesh, opt, pcfg)) == _shape_tree(state))
    step = steps.make_train_step(cfg, pcfg, mesh, opt, AttackConfig("sign_flip", 0.25))
    params, opt_state = state["params"], state["opt_state"]
    dcfg = pipeline.DataConfig(**DATA)
    for i in range(STEPS):
        batch = pipeline.make_lm_batch(dcfg, i, None, device="cpu")
        params, opt_state, _ = step(params, opt_state, batch, i)
    out["train_step/params"] = params
    out["whisper_agg"] = _whisper_aggregate(mesh)
    for arch in FAMILIES:
        out[f"{arch}/params"] = _family_step(mesh, arch)
    return out


def _numpy(t):
    """A tensor as numpy, bfloat16 widened to float32 (exactly)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _flat(out):
    flat = {}
    for name, v in out.items():
        if torch.is_tensor(v):
            flat[name] = _numpy(v)
        else:
            for path, t in tree_leaves_with_path(v):
                flat[f"{name}/{path}"] = _numpy(t)
    return flat


def run_rank(rank: int, rendezvous: str, inputs: str, outdir: str) -> None:
    """One rank of the module's process group: :func:`jobs` on this rank's
    shards, outputs to ``outdir``."""
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    mesh = mesh_lib.make_production_mesh(device="cpu")
    assert mesh.per_rank and mesh.rank == rank
    flat = _flat(jobs(mesh, dict(np.load(inputs))))
    flat["calls"] = np.array(json.dumps(dict(mesh.axes.calls)))
    np.savez(f"{outdir}/rank{rank}.npz", **flat)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, each rank's outputs, the reference's outputs, the in-process
    jobs): the 4 ranks, the reference's subprocess and the in-process jobs
    run once, at the same time."""
    d = tmp_path_factory.mktemp("fsdp")
    data = _gather_inputs()
    np.savez(d / "in.npz", **data)
    spec = {"gather": {k: list(v) for k, v in GATHER.items()}, "tiny": TINY, "data": DATA,
            "lr": SGD_LR, "steps": STEPS}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", REF_SCRIPT, json.dumps(spec),
                               str(d / "in.npz"), str(d / "ref.npz")], env=ref_env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, os.path.join(ROOT, "tests"),
                                str(r), str(d / "rendezvous"), str(d / "in.npz"), str(d)],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True) for r in range(WORLD)]
    logs = []
    try:
        mesh = mesh_lib.make_debug_mesh(WORLD, 1, device="cpu")
        here = _flat(jobs(mesh, data))  # the in-process jobs while the others run
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for name, p, log in zip(["reference"] + [f"rank {r}" for r in range(WORLD)], procs, logs):
        assert p.returncode == 0, f"{name}: {log[-4000:]}"
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return data, outs, dict(np.load(d / "ref.npz")), (here, mesh)


@pytest.fixture(scope="module")
def in_process(runs):
    """(the in-process jobs' outputs, the debug mesh they ran on)."""
    return runs[3]


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


def _chunks(cfg, flat, prefix, rank):
    """{path: rank's chunk} of the in-process global view ``flat[prefix/...]``
    by the FSDP dims at m = WORLD."""
    dims = dict(tree_leaves_with_path(steps.fsdp_dims(
        cfg, mesh_lib.make_debug_mesh(WORLD, 1, device="cpu"))))
    out = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            path = key[len(prefix):]
            d = dims[path]
            out[path] = v if d < 0 else np.split(v, WORLD, axis=d)[rank]
    return out


# ---------------------------------------------------------------------------
# partition rules and FSDP dims: pure shape functions against the reference
# ---------------------------------------------------------------------------

VARIANTS = [(arch, smoke) for arch in configs.ARCHITECTURES for smoke in (False, True)]
IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in VARIANTS]


def _configs(arch, smoke):
    if smoke:
        return configs.get_smoke_config(arch), ref_get_smoke_config(arch)
    return configs.get_config(arch), ref_get_config(arch)


def _ref_leaves(tree, is_leaf=None):
    """[(path, leaf)] of a reference tree, paths as the port's."""
    import jax

    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


def _is_spec(x):
    from jax.sharding import PartitionSpec

    return isinstance(x, PartitionSpec)


def _port_leaves(cfg, tree):
    """[(path, leaf)] of a tree shaped like the params whose leaves may be
    tuples (specs)."""
    paths = [p for p, _ in tree_leaves_with_path(T.meta_params(cfg))]
    leaves = []
    tree_map(lambda _, x: leaves.append(x), T.meta_params(cfg), tree)
    return list(zip(paths, leaves))


def _ref_mesh(shape):
    """A stand-in for the reference's mesh: its fsdp_dims reads the axis
    names and ``devices.shape`` only."""
    return types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(shape))


@pytest.mark.parametrize("arch,smoke", VARIANTS, ids=IDS)
def test_partition_specs_match_the_reference(arch, smoke):
    """``tree_partition_specs`` (and ``param_partition_spec`` leaf by leaf)
    at model sizes 1, 2 and 16 equal the reference's, paths and shapes
    too; at model size 1 every leaf with a rule takes ``model``."""
    cfg, rcfg = _configs(arch, smoke)
    shapes = RT.param_shapes(rcfg)
    port_shapes = [(p, tuple(t.shape)) for p, t in tree_leaves_with_path(T.meta_params(cfg))]
    assert port_shapes == [(p, tuple(x.shape)) for p, x in _ref_leaves(shapes)]
    for mm in (1, 2, 16):
        want = [(p, tuple(s)) for p, s in _ref_leaves(
            ref_sharding.tree_partition_specs(shapes, "model", mm), _is_spec)]
        got = _port_leaves(cfg, sharding.tree_partition_specs(T.meta_params(cfg), "model", mm))
        assert got == want, (arch, mm)
        for (path, shape), (_, spec) in zip(port_shapes, got):
            assert sharding.param_partition_spec(path, shape, "model", mm) == spec
    at_1 = _port_leaves(cfg, sharding.tree_partition_specs(T.meta_params(cfg), "model", 1))
    for path, spec in at_1:
        assert ("model" in spec) == (path.split("/")[-1] in sharding.RULES), path
    mesh = mesh_lib.Mesh(("data", "model"), (4, 1), torch.device("cpu"),
                         D.InProcessAxes({"data": 4}, "cpu"))
    assert _port_leaves(cfg, steps.param_shardings(cfg, mesh)) == at_1


@pytest.mark.parametrize("arch,smoke", VARIANTS, ids=IDS)
def test_fsdp_dims_and_specs_match_the_reference(arch, smoke, monkeypatch):
    """``fsdp_dims``, ``fsdp_param_shardings`` and ``fsdp_manual_specs`` at m
    in {2, 4} with model 1, and at (4, 2), equal the reference's (its
    NamedShardings read as their specs); no leaf of any configuration is
    replicated at m = 4, model 1."""
    cfg, rcfg = _configs(arch, smoke)
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    for shape in ((2, 1), (4, 1), (4, 2)):
        mesh = mesh_lib.Mesh(("data", "model"), shape, torch.device("cpu"),
                             D.InProcessAxes({"data": shape[0]}, "cpu"))
        rmesh = _ref_mesh(shape)
        want = [d for _, d in _ref_leaves(ref_steps.fsdp_dims(rcfg, rmesh))]
        dims = steps.fsdp_dims(cfg, mesh)
        assert tree_leaves(dims) == want, (arch, shape)
        specs, dims2 = steps.fsdp_param_shardings(cfg, mesh)
        assert tree_leaves(dims2) == want
        rspecs, _ = ref_steps.fsdp_param_shardings(rcfg, rmesh)
        assert [s for _, s in _port_leaves(cfg, specs)] == \
            [tuple(s) for _, s in _ref_leaves(rspecs, _is_spec)], (arch, shape)
        assert [s for _, s in _port_leaves(cfg, steps.fsdp_manual_specs(cfg, mesh))] == \
            [tuple(s) for _, s in _ref_leaves(ref_steps.fsdp_manual_specs(rcfg, rmesh),
                                              _is_spec)], (arch, shape)
        if shape == (4, 1):
            assert min(want) >= 0, arch


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama3-405b", "qwen3-14b"])
def test_fsdp_dims_avoid_the_model_dim(arch):
    """tests/test_dryrun_lite.py's model-2 case from the spec trees alone: on
    a (data 4, model 2) mesh every FSDP dim carries ``data``, and the model
    axis survives on some leaves beside it."""
    cfg = configs.get_config(arch)
    mesh = mesh_lib.Mesh(("data", "model"), (4, 2), torch.device("cpu"),
                         D.InProcessAxes({"data": 4}, "cpu"))
    specs, dims = steps.fsdp_param_shardings(cfg, mesh)
    n_2d = 0
    for (path, spec), d in zip(_port_leaves(cfg, specs), tree_leaves(dims)):
        if d >= 0:
            assert spec[d] == "data", (path, spec, d)
            n_2d += "model" in spec
    assert n_2d > 0


def test_fsdp_shard_and_abstract_state_shapes():
    """The meta-device state: the reference's global shapes (params and
    AdamW moments) in process and on a replicated mesh; the shard shapes
    (dim // m) under a process group of m; ``fsdp_shard`` cuts chunk w."""
    import jax

    from repro.optim.optimizers import get_optimizer as ref_get_optimizer

    cfg = configs.get_config("llama3.2-3b")
    rshapes = RT.param_shapes(ref_get_config("llama3.2-3b"))
    ropt = jax.eval_shape(ref_get_optimizer("adamw", 1e-3).init, rshapes)
    want = [tuple(x.shape) for _, x in _ref_leaves(rshapes)]
    opt = get_optimizer("adamw", 1e-3)
    ax = D.InProcessAxes({"data": WORLD}, "cpu")
    inproc = mesh_lib.Mesh(("data", "model"), (WORLD, 1), torch.device("cpu"), ax)
    per_rank = dataclasses.replace(inproc, rank=1, per_rank=True)
    dims = tree_leaves(steps.fsdp_dims(cfg, inproc))
    for mesh, mode in ((inproc, "fsdp"), (per_rank, "replicated")):
        st = trainer.abstract_state(cfg, mesh, opt, ParallelConfig(param_mode=mode))
        assert [tuple(t.shape) for t in tree_leaves(st["params"])] == want
        assert [tuple(t.shape) for t in tree_leaves(st["opt_state"])] == \
            [tuple(x.shape) for _, x in _ref_leaves(ropt)]
        assert all(t.device.type == "meta" for t in tree_leaves(st))
    st = trainer.abstract_state(cfg, per_rank, opt, ParallelConfig(param_mode="fsdp"))
    shard = [tuple(s // WORLD if i == d else s for i, s in enumerate(shape))
             for shape, d in zip(want, dims)]
    assert [tuple(t.shape) for t in tree_leaves(st["params"])] == shard
    assert [tuple(t.shape) for t in tree_leaves(st["opt_state"]["m"])] == shard
    assert st["opt_state"]["v"]["embed"].dtype == torch.float32
    full = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(steps.fsdp_shard({"w": full}, {"w": 1}, 2, 3)["w"], full[:, 4:6])
    assert steps.fsdp_shard({"w": full}, {"w": -1}, 2, 3)["w"] is full


# ---------------------------------------------------------------------------
# the gather's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GATHER))
def test_gather_backward_matches_the_reference(runs, in_process, name):
    """In process and on each of the 4 gloo ranks: each worker's shard
    gradient is its chunk of the robust aggregate of the 4 workers'
    gradients, bitwise the reference's shard_map output on exact data; on
    normal data within tests/test_distributed.py's tolerance of the numpy
    median of the per-worker gradients (each side's matmuls round their
    own way)."""
    data, outs, ref, _ = runs
    shape, dim, method, _, exact = GATHER[name]
    got = in_process[0][f"gather/{name}"]  # (4, shard)
    glob = np.concatenate(list(got), axis=dim)
    if exact:
        assert _bits_equal(glob, ref[f"gather/{name}"]), name
    else:
        w, x = data[f"{name}/w"], data[f"{name}/x"]
        want = np.median(np.stack([2 * xi.T @ (xi @ w) for xi in x]), axis=0)
        np.testing.assert_allclose(glob, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ref[f"gather/{name}"], want, rtol=1e-4, atol=1e-5)
    for r, out in enumerate(outs):
        if exact:
            assert _bits_equal(out[f"gather/{name}"], got[r]), (name, r)
        else:  # one worker's matmul against the in-process batched one
            np.testing.assert_allclose(out[f"gather/{name}"], got[r], rtol=1e-4, atol=1e-5)


def test_gather_forward_is_the_all_gather():
    """The forward gives every worker the whole tensor (its own copy in
    process) and counts one all_gather; the backward one all_to_all."""
    ax = D.InProcessAxes({"data": WORLD}, "cpu")
    w = torch.arange(24.0).reshape(3, 8)
    shards = torch.stack(w.chunk(WORLD, 1)).requires_grad_(True)
    full = D.make_robust_param_gather_dim(ax, ("data",), 1)(shards)
    assert full.shape == (WORLD, 3, 8) and all(torch.equal(f, w) for f in full)
    full.sum().backward()
    assert torch.equal(shards.grad, torch.ones_like(shards))
    assert dict(ax.calls) == {"all_gather": 1, "all_to_all": 1}
    rows = D.make_robust_param_gather(ax, ("data",))(torch.stack(w.T.chunk(WORLD, 0)))
    assert torch.equal(rows[2], w.T)


# ---------------------------------------------------------------------------
# the fsdp step and trainer
# ---------------------------------------------------------------------------


def test_fsdp_step_matches_the_reference(runs):
    """The tiny llama, fsdp gather median under sign_flip alpha 0.25, 3
    steps from the reference's params on its batches, in process: losses
    and grad norms within 1e-6 relative, params within 1e-5 of the
    reference's fsdp run (SGD 0.5; module docstring)."""
    ref = runs[2]
    cfg, pcfg = _tiny(), _pcfg()
    mesh = mesh_lib.make_debug_mesh(WORLD, 1, device="cpu")
    opt = get_optimizer("sgd", SGD_LR)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    state["params"] = convert.transformer_from_reference(cfg, _nested(ref, "init/"), "cpu")
    window = trainer.make_window_step(cfg, pcfg, mesh, opt, AttackConfig("sign_flip", 0.25), 1)
    losses, norms = [], []
    for i in range(STEPS):
        before = {k: float(v) for k, v in state["metrics"].items()}
        batch = {k: torch.from_numpy(ref[f"batch/{i}/{k}"])[None] for k in ("tokens", "labels")}
        state = window(state, batch)
        met = trainer.window_metrics(before, state)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
    np.testing.assert_allclose(losses, ref["fsdp/loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, ref["fsdp/grad_norm"], rtol=LOSS_RTOL)
    want = _nested(ref, "fsdp/params/")
    for path, t in tree_leaves_with_path(state["params"]):
        w = want
        for p in path.split("/"):
            w = w[p]
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=PARAM_ATOL, err_msg=path)
    assert not np.array_equal(state["params"]["embed"].numpy(), _nested(ref, "init/")["embed"])


@pytest.mark.parametrize("cell", list(CELLS))
def test_fsdp_is_bitwise_replicated_in_process(in_process, cell):
    """3 AdamW steps of the tiny llama: fsdp's params, losses and the
    aggregates bitwise the replicated gather's (median under sign_flip;
    trimmed mean beta 0.25 under ALIE), grad norms within 1e-6 (summed in
    another order)."""
    method, beta, attack = CELLS[cell]
    mesh = in_process[1]
    rep = _train(mesh, method, beta, attack, mode="replicated")
    got = in_process[0]
    for path, t in tree_leaves_with_path(rep.state["params"]):
        assert _bits_equal(got[f"{cell}/params/{path}"], t.numpy()), path
    assert _bits_equal(got[f"{cell}/loss"], np.array([h["loss"] for h in rep.history],
                                                     np.float32))
    np.testing.assert_allclose(got[f"{cell}/grad_norm"],
                               [h["grad_norm"] for h in rep.history], rtol=LOSS_RTOL)


@pytest.mark.parametrize("cell", list(CELLS) + ["train_step"])
def test_process_group_shards_are_the_global_view_chunks(runs, in_process, cell):
    """Each gloo rank's params after 3 fsdp steps are bitwise its chunk of the
    in-process global view (also through ``make_train_step``); losses
    bitwise, grad norms within 1e-6 relative."""
    outs = runs[1]
    got = in_process[0]
    for r, out in enumerate(outs):
        want = _chunks(_tiny(), got, f"{cell}/params/", r)
        assert want
        for path, w in want.items():
            assert _bits_equal(out[f"{cell}/params/{path}"], w), (cell, r, path)
        if cell != "train_step":
            assert _bits_equal(out[f"{cell}/loss"], got[f"{cell}/loss"])
            np.testing.assert_allclose(out[f"{cell}/grad_norm"], got[f"{cell}/grad_norm"],
                                       rtol=LOSS_RTOL)


def test_make_train_step_is_the_window(in_process):
    """``make_train_step`` under fsdp from ``init_state``: the window's
    params (train_loop at device_steps 1) bit for bit."""
    got = in_process[0]
    keys = [k for k in got if k.startswith("train_step/params/")]
    assert keys
    for k in keys:
        assert _bits_equal(got[k], got["median_signflip/params/" + k[len("train_step/params/"):]])


def test_abstract_state_is_the_state(runs, in_process):
    """``abstract_state`` under fsdp has the state's paths, shapes and dtypes,
    in process and on every rank (the rank's shards)."""
    assert bool(in_process[0]["abstract_state_shapes_match"])
    assert all(bool(out["abstract_state_shapes_match"]) for out in runs[1])


def test_unused_cross_ffn_shards_are_zero(runs, in_process):
    """whisper-smoke under fsdp: the cross blocks' FFN leaves never reach the
    loss, so their aggregate is exactly 0 on every rank's shards and in the
    in-process global view (their gathers run no backward and no
    collective); the used leaves move."""
    got = in_process[0]
    cfg = configs.get_smoke_config("whisper-small")
    for r, out in enumerate([got] + runs[1]):
        for leaf in ("wq", "wk", "wv", "wo", "ln1") + CROSS_FFN:
            a = out[f"whisper_agg/cross_blocks/{leaf}"]
            assert a.any() != (leaf in CROSS_FFN), (r, leaf)
        assert out["whisper_agg/enc_blocks/wq"].any()
    for r, out in enumerate(runs[1]):
        for path, w in _chunks(cfg, got, "whisper_agg/", r).items():
            assert _bits_equal(out[f"whisper_agg/{path}"], w), (r, path)
    calls = [json.loads(str(out["calls"])) for out in runs[1]]
    assert all(c == calls[0] for c in calls) and calls[0]["all_to_all"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_fsdp_is_replicated(runs, in_process, arch):
    """One fsdp step of the hybrid (its tail gathered whole), MoE and SSM
    smoke configs: in process bitwise the replicated gather's params, and
    every rank's shards bitwise the in-process global view's chunks."""
    got, mesh = in_process
    for path, t in tree_leaves_with_path(_family_step(mesh, arch, "replicated")):
        assert _bits_equal(got[f"{arch}/params/{path}"], _numpy(t)), path
    cfg = configs.get_smoke_config(arch)
    for r, out in enumerate(runs[1]):
        for path, w in _chunks(cfg, got, f"{arch}/params/", r).items():
            assert _bits_equal(out[f"{arch}/params/{path}"], w), (r, path)


def test_grad_norm_counts_a_replicated_leaf_m_times():
    """The reference's fsdp grad_norm psums every worker's sum of squares,
    so a replicated leaf (no dim divisible by m) counts m times: at m = 3
    the tiny llama with d_ff 96 shards its FFN leaves only, and the norm is
    sqrt(sum over sharded leaves + 3 x sum over replicated ones) of the
    aggregate, which equals the replicated gather's."""
    cfg = dataclasses.replace(_tiny(), d_ff=96)
    mesh = mesh_lib.make_debug_mesh(3, 1, device="cpu")
    dims = tree_leaves(steps.fsdp_dims(cfg, mesh))
    assert -1 in dims and max(dims) >= 0
    dcfg = pipeline.DataConfig(vocab=128, seq_len=16, global_batch=6, num_workers=3, seed=0)
    batch = pipeline.make_lm_batch(dcfg, 0, None, device="cpu")
    aggs, norms = {}, {}
    for mode in ("replicated", "fsdp"):
        opt, seen = _recording(get_optimizer("adamw", ADAMW_LR))
        state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=_pcfg(mode=mode))
        _, _, met = steps.make_train_step(cfg, _pcfg(mode=mode), mesh, opt)(
            state["params"], state["opt_state"], batch, 0)
        aggs[mode], norms[mode] = tree_leaves(seen[0]), float(met["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(aggs["replicated"], aggs["fsdp"]))
    sq = [float(torch.sum(a.double() ** 2)) for a in aggs["fsdp"]]
    want = np.sqrt(sum(s * (3 if d < 0 else 1) for s, d in zip(sq, dims)))
    np.testing.assert_allclose(norms["fsdp"], want, rtol=1e-6)
    np.testing.assert_allclose(norms["replicated"], np.sqrt(sum(sq)), rtol=1e-6)
    assert norms["fsdp"] > norms["replicated"] * (1 + 1e-3)


def test_fsdp_refusals():
    """As the reference refuses them: a codec, local steps and a randomized
    attack under fsdp (build time, make_step_body and through the window)."""
    cfg = _tiny()
    mesh = mesh_lib.make_debug_mesh(WORLD, 1, device="cpu")
    opt = get_optimizer("adamw", ADAMW_LR)
    for codec in ("int8", "topk"):
        with pytest.raises(ValueError, match="compression needs param_mode='replicated'"):
            steps.make_step_body(cfg, ParallelConfig(param_mode="fsdp", compression=codec),
                                 mesh, opt)
    with pytest.raises(ValueError, match="local_steps > 1 needs param_mode='replicated'"):
        steps.make_step_body(cfg, ParallelConfig(param_mode="fsdp", local_steps=2), mesh, opt)
    with pytest.raises(ValueError, match="local_steps"):  # tests/test_rounds.py's
        steps.make_train_step(cfg, ParallelConfig(param_mode="fsdp", local_steps=4), mesh,
                              get_optimizer("sgd", 1e-2))
    with pytest.raises(ValueError, match="'gauss' is randomized"):
        trainer.make_window_step(cfg, ParallelConfig(param_mode="fsdp"), mesh, opt,
                                 AttackConfig("gauss", 0.25))
    with pytest.raises(ValueError, match="unknown param_mode"):
        steps.make_step_body(cfg, ParallelConfig(param_mode="zero3"), mesh, opt)
    steps.make_step_body(cfg, ParallelConfig(param_mode="fsdp"), mesh, opt,
                         AttackConfig("gauss", 0.0))  # no attack at alpha 0
