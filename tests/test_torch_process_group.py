"""``ProcessGroupAxes`` — the ``torch.distributed`` process group behind the
worker-axis ``Collectives`` — under 4 gloo ranks on the CPU, held against
the reference's shard_map programs and against ``InProcessAxes`` on the
same rows.

The 4 ranks are spawned once for the module (one process each, a
``file://`` rendezvous under the test's temporary directory, so no TCP
port is taken); each runs :func:`jobs` with this rank's own rows and
saves its outputs.  At the same time the reference runs the same
strategies, sketch and round programs once, in one subprocess on 4 forced
CPU devices (its own tests' harness:
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), over ``("data",)``
= 4 and ``("pod", "data")`` = (2, 2), on the same numpy rows.  The tests
hold every rank's outputs against the reference's, and against the same
jobs over ``InProcessAxes`` on the stacked rows in this process (a second
witness).  The inputs are tests/test_torch_distributed.py's leaf shapes and
seeds at m = 4, tests/test_rounds.py's linear-regression layout (d = 6,
n = 32) at m = 4, and the reference's codec draws (int8 per worker,
count_sketch one map) injected into the port.

Tolerances against the reference, stated where used (those of
tests/test_torch_distributed.py and tests/test_torch_rounds_distributed.py):
- medians, the sketch's min/max, gathers, all_to_all buckets, attacks on
  the gathered rows, codecs with the injected draws: bitwise;
- trimmed means: within 1 ulp (the reference's jit multiplies by the
  reciprocal of m - 2·trim);
- sums the two add in their own orders (the psum strategy, the chunked
  mean, the sketch's sums, ALIE's payloads and the row-free psum / chunked
  attacks): 1e-6 relative + 1e-7 absolute (sums 1e-6 absolute; attacks
  1e-5 + 1e-6);
- the sketch's bin counts: equal; the chunked median within 2 ulp of the
  larger end of each coordinate's range (XLA contracts the bin centre to
  an FMA), the chunked trimmed mean within one bin width;
- one round on the same per-worker rows (a replay solver returning a
  seeded third data leaf): gather and bucketed bitwise, chunked within one
  bin width; with each package's own quadratic solver 1e-5 absolute (the
  linear solves round differently), chunked plus one bin width;
- local-update rounds (τ = 4), each from the same seeded iterate: 1e-6
  relative + 1e-7 absolute, chunked within η times one bin width of the
  round's accumulated gradients.

Against ``InProcessAxes``: order statistics bitwise, backend sums 1e-6
relative + 1e-7 absolute (ALIE 1e-5 + 1e-6), bin counts equal.
"""
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MEAN_RTOL, MEAN_ATOL = 1e-6, 1e-7
COMP_KEY = 5
LU = dict(method="median", step_size=0.05, tau=4)
LU_ROUNDS = 3
ATTACKS = (("large_value", dict(scale=1e6)), ("sign_flip", dict(scale=5.0)), ("alie", {}),
           ("mimic", {}), ("local_sign_flip", {}))
TRAIN = ["--config", "llama3.2-3b", "--smoke", "--steps", "3", "--seq-len", "16",
         "--global-batch", "4", "--device", "cpu"]
TRAIN_RUNS = {"psum": ["--strategy", "psum", "--agg", "mean"],
              "gather_median": ["--strategy", "gather", "--agg", "median", "--attack", "alie",
                                "--attack-alpha", "0.25"]}
SERVE_CI = ["--device", "cpu", "--smoke", "--arch", "llama3_2_3b", "--workers", "2",
            "--model-par", "1", "--requests", "24", "--alpha", "0.25", "--attack",
            "feedback_flip"]
RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_process_group as T
T.run_rank(int(sys.argv[2]), *sys.argv[3:])
"""

REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import distributed
from repro.core.attacks import AttackConfig
from repro.core.robust_gd import linreg_loss
from repro.kernels import histogram_agg as H
from repro.rounds import (LocalUpdateConfig, OneRoundConfig, make_local_update_round,
                          one_round_distributed, quadratic_local_solver)
from repro.rounds import distributed as rd

data = dict(np.load(sys.argv[1]))
out = {}

def dump(name, tree):
    for i, v in enumerate(jax.tree.leaves(tree)):
        out[f"{name}/{i}"] = np.asarray(v)

def one_mesh(jobs, keys, shape, axes):
    # every job of a mesh in ONE shard_map body: one compile
    def body(*args):
        local = {k: a[0] for k, a in zip(keys, args)}
        return {name: fn({k: local[k] for k in ks}) for name, ks, fn in jobs}
    mesh = jax.make_mesh(shape, axes)
    f = jax.shard_map(body, mesh=mesh, in_specs=tuple(P(axes) for _ in keys), out_specs=P(),
                      axis_names=set(axes), check_vma=False)
    res = jax.jit(f)(*[jnp.asarray(data[k]) for k in keys])
    for name, _, _ in jobs:
        dump(name, res[name])

def sketch(x):
    lo, hi = jax.lax.pmin(x, "data"), jax.lax.pmax(x, "data")
    counts, sums = H.hist_update(*H.hist_init(x.shape[0], 256, with_sums=True), x[None, :],
                                 lo, (hi - lo) / 256)
    return (lo, hi), jax.lax.psum(counts, "data"), jax.lax.psum(sums, "data")

def bits(x):
    return jax.lax.bitcast_convert_type(x, jnp.int16)

leaf = ["leaf_a", "leaf_b"]
coal = [f"coal_{i}" for i in range(8)]
atk_keys = [f"atk_{i}" for i in range(4)]
jobs = []
for method in ("median", "trimmed_mean", "mean"):
    jobs.append((f"gather_{method}", leaf, lambda t, m=method: distributed.robust_gather_agg(
        t, ("data",), m, beta=0.25)))
    for gran in ("leaf", "flat"):
        jobs.append((f"bucketed_{gran}_{method}", leaf,
                     lambda t, m=method, g=gran: distributed.robust_bucketed_agg(
                         t, ("data",), m, beta=0.25, granularity=g)))
    jobs.append((f"chunked_{method}", ["g3"], lambda t, m=method: distributed.robust_chunked_agg(
        t, ("data",), m, beta=0.25, nbins=512, coord_chunk=16)))
jobs.append(("coalesced", coal, lambda t: distributed.robust_bucketed_agg(t, ("data",),
                                                                          "median")))
jobs.append(("psum", leaf, lambda t: distributed.robust_psum_agg(t, ("data",), "mean")))
jobs.append(("rs", ["leaf_a"], lambda t: jax.lax.all_gather(
    distributed.robust_reduce_scatter(t["leaf_a"], ("data",), "median"), "data")))
jobs.append(("minmax", ["g3"], lambda t: sketch(t["g3"])[0]))
jobs.append(("counts", ["g3"], lambda t: sketch(t["g3"])[1]))
jobs.append(("sums", ["g3"], lambda t: sketch(t["g3"])[2]))
for aname, kw in (("large_value", dict(scale=1e6)), ("sign_flip", dict(scale=5.0)),
                  ("alie", {}), ("mimic", {}), ("local_sign_flip", {})):
    atk = AttackConfig(aname, alpha=0.25, **kw)
    for strat in ("gather", "bucketed", "psum", "chunked"):
        if aname == "mimic" and strat in ("psum", "chunked"):
            continue
        method = "mean" if strat == "psum" else "median"
        jobs.append((f"attack_{aname}_{strat}", atk_keys,
                     lambda t, s=strat, a=atk, me=method: rd.aggregate_by_strategy(
                         t, ("data",), s, me, 0.25, a, attack_key=jax.random.PRNGKey(3))))
for comp in ("int8", "count_sketch"):
    for strat in ("gather", "bucketed"):
        jobs.append((f"comp_{comp}_{strat}", leaf,
                     lambda t, c=comp, s=strat: rd.aggregate_by_strategy(
                         t, ("data",), s, "median", compression=c,
                         comp_key=jax.random.PRNGKey(5))))
jobs.append(("bf16_gather", ["leaf_a"], lambda t: bits(jax.lax.all_gather(
    t["leaf_a"].astype(jnp.bfloat16), "data"))))
jobs.append(("bf16_median", ["leaf_a"], lambda t: bits(distributed.robust_gather_agg(
    {"a": t["leaf_a"].astype(jnp.bfloat16)}, ("data",), "median")["a"])))
one_mesh(jobs, leaf + coal + atk_keys + ["g3"], (4,), ("data",))
one_mesh([("multi_axis", ["g2"], lambda t: distributed.robust_bucketed_agg(
              t, ("pod", "data"), "median")),
          ("hierarchical", ["g2"], lambda t: distributed.robust_hierarchical_agg(
              t, "data", "pod", "median"))], ["g2"], (2, 2), ("pod", "data"))

# the round programs on the linear-regression shards (d = 6, n = 32, m = 4)
mesh = jax.make_mesh((4,), ("data",))
shards = (jnp.asarray(data["x"]), jnp.asarray(data["y"]))
replay = shards + (jnp.asarray(data["sol"]),)
out["solutions"] = np.asarray(jax.vmap(quadratic_local_solver)(shards))
atk = AttackConfig("sign_flip", alpha=0.25, scale=10.0)
cfg = LocalUpdateConfig(method="median", step_size=0.05, tau=4)
for strat in ("gather", "bucketed", "chunked"):
    dump(f"one_round_{strat}", one_round_distributed(
        quadratic_local_solver, shards, mesh, OneRoundConfig("median"), strategy=strat))
    dump(f"one_round_replay_{strat}", one_round_distributed(
        lambda b: b[2], replay, mesh, OneRoundConfig("median"), strategy=strat))
    dump(f"one_round_replay_atk_{strat}", one_round_distributed(
        lambda b: b[2], replay, mesh, OneRoundConfig("median"), strategy=strat, attack=atk))
    step = make_local_update_round(linreg_loss, cfg, mesh, strategy=strat)
    dump(f"local_update_{strat}", [step(jnp.asarray(w), shards, jnp.int32(r))
                                   for r, w in enumerate(data["w_iter"])])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _rows(seed, shape, m=WORLD):
    return np.random.default_rng(seed).standard_normal((m,) + shape).astype(np.float32)


def _inputs():
    data = {"leaf_a": _rows(1, (37,)), "leaf_b": _rows(2, (3, 5)), "g2": _rows(3, (26,)),
            "g3": _rows(4, (100,))}
    for i, s in enumerate([(40,)] * 6 + [(300,), (30, 10)]):
        data[f"coal_{i}"] = _rows(10 + i, s)
    for i, s in enumerate([(11,), (11,), (4, 3), (64,)]):
        data[f"atk_{i}"] = _rows(20 + i, s)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((WORLD * 32, 6)).astype(np.float32)
    w_star = (rng.standard_normal(6) / np.sqrt(6)).astype(np.float32)
    y = (x @ w_star + 0.3 * rng.standard_normal(WORLD * 32)).astype(np.float32)
    data["x"], data["y"] = x.reshape(WORLD, 32, 6), y.reshape(WORLD, 32)
    data["sol"] = (w_star + 0.1 * _rows(30, (6,))).astype(np.float32)  # replayed solutions
    data["w_iter"] = (0.5 * _rows(31, (6,), LU_ROUNDS)).astype(np.float32)  # a round's start
    data.update(_codec_draws(37 + 15))
    return data


def _codec_draws(d):
    """The reference's codec draws for the (leaf_a, leaf_b) message of d
    coordinates under key COMP_KEY: int8's per worker (the key folded with
    the worker index), count_sketch's one shared map."""
    import jax

    from repro_torch.rounds import compression as C

    key = jax.random.PRNGKey(COMP_KEY)
    kh, ks = jax.random.split(key)
    return {"int8_draw": np.stack([np.asarray(jax.random.uniform(
                jax.random.fold_in(key, w), C.int8_draw_shape(d))) for w in range(WORLD)]),
            "sketch_h": np.array(jax.random.randint(kh, (d,), 0, C._sketch_w(d, 0.5))),
            "sketch_s": np.array(jax.random.bernoulli(ks, 0.5, (d,)), np.float32) * 2 - 1}


def jobs(D, ax, ax2, take, data):
    """Every job over the axes ``ax`` ({"data": 4}) and ``ax2`` ({"pod": 2,
    "data": 2}); ``take(key)`` is the input as the axes want it (stacked
    rows in process, this rank's row under the process group), ``data``
    the whole numpy inputs.  Returns {name: (tree, exact, varying)}:
    ``exact`` holds it bitwise against the in-process axes, ``varying``
    outputs differ by worker (``"pod"``: by pod)."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import linreg_loss
    from repro_torch.launch.mesh import Mesh
    from repro_torch.rounds import (LocalUpdateConfig, OneRoundConfig, aggregate_by_strategy,
                                    make_local_update_round, one_round_distributed,
                                    quadratic_local_solver)

    names = ("data",)
    leaf = {k: take(k) for k in ("leaf_a", "leaf_b")}
    out = {}
    for method in ("median", "trimmed_mean", "mean"):
        out[f"gather_{method}"] = (D.robust_gather_agg(leaf, ax, names, method, beta=0.25), True,
                                   False)
        for gran in ("leaf", "flat"):
            out[f"bucketed_{gran}_{method}"] = (D.robust_bucketed_agg(
                leaf, ax, names, method, beta=0.25, granularity=gran), True, False)
        out[f"chunked_{method}"] = (D.robust_chunked_agg(
            {"g3": take("g3")}, ax, names, method, beta=0.25, nbins=512, coord_chunk=16),
            method == "median", False)
    out["coalesced"] = (D.robust_bucketed_agg({f"coal_{i}": take(f"coal_{i}") for i in range(8)},
                                              ax, names, "median"), True, False)
    out["psum"] = (D.robust_psum_agg(leaf, ax, names, "mean"), False, False)
    out["rs"] = (D.robust_reduce_scatter(take("leaf_a"), ax, names, "median"), True, True)
    x3 = take("g3")
    lo, hi = ax.pminmax(x3, names)
    counts, sums = ax.psum_histogram(x3, lo, (hi - lo) / 256, 256, True, names)
    out["minmax"] = ((lo, hi), True, False)
    out["counts"] = (counts, True, False)
    out["sums"] = (sums, False, False)
    atk_leaf = {f"atk_{k}": take(f"atk_{k}") for k in range(4)}
    for aname, kw in ATTACKS:
        atk = AttackConfig(aname, alpha=0.25, **kw)
        for strat in ("gather", "bucketed", "psum", "chunked"):
            if aname == "mimic" and strat in ("psum", "chunked"):
                continue
            exact = strat in ("gather", "bucketed")
            out[f"attack_{aname}_{strat}"] = (aggregate_by_strategy(
                atk_leaf, ax, names, strat, "mean" if strat == "psum" else "median", 0.25, atk,
                attack_key=3), exact, False)
    draws = {"int8": lambda w: torch.from_numpy(data["int8_draw"][w]),
             "count_sketch": lambda w: (torch.from_numpy(data["sketch_h"]),
                                        torch.from_numpy(data["sketch_s"]))}
    for comp in ("int8", "count_sketch"):
        for strat in ("gather", "bucketed"):
            # the port's own draws (no reference counterpart), then the reference's
            out[f"codec_{comp}_{strat}"] = (aggregate_by_strategy(
                leaf, ax, names, strat, "median", compression=comp, comp_key=COMP_KEY), True,
                False)
            out[f"comp_{comp}_{strat}"] = (aggregate_by_strategy(
                leaf, ax, names, strat, "median", compression=comp, comp_draw=draws[comp]),
                True, False)
    g2 = take("g2_pods")
    out["multi_axis"] = (D.robust_bucketed_agg({"g2": g2}, ax2, ("pod", "data"), "median"),
                         True, False)
    out["hierarchical"] = (D.robust_hierarchical_agg({"g2": g2}, ax2, "data", "pod", "median"),
                           True, False)
    out["inner_gather"] = (ax2.all_gather(g2, ("data",)), True, "pod")
    bf = take("leaf_a").to(torch.bfloat16)
    out["bf16_gather"] = (ax.all_gather(bf, names).view(torch.int16), True, False)
    out["bf16_median"] = (D.robust_gather_agg({"a": bf}, ax, names, "median")["a"]
                          .view(torch.int16), True, False)
    # the round programs on the linear-regression shards (d = 6, n = 32, m = 4)
    mesh = Mesh(("data", "model"), (WORLD, 1), torch.device("cpu"), ax)
    shards = (take("x"), take("y"))
    replay = shards + (take("sol"),)
    atk = AttackConfig("sign_flip", alpha=0.25, scale=10.0)
    for strat in ("gather", "bucketed", "chunked"):
        out[f"one_round_{strat}"] = (one_round_distributed(
            quadratic_local_solver, shards, mesh, OneRoundConfig("median"), strategy=strat),
            True, False)
        for tag, a in (("replay", None), ("replay_atk", atk)):
            out[f"one_round_{tag}_{strat}"] = (one_round_distributed(
                lambda b: b[2], replay, mesh, OneRoundConfig("median"), strategy=strat,
                attack=a), True, False)
        step = make_local_update_round(linreg_loss, LocalUpdateConfig(**LU), mesh,
                                       strategy=strat)
        out[f"local_update_{strat}"] = ([step(torch.from_numpy(w), shards, r)
                                         for r, w in enumerate(data["w_iter"])], True, False)
    return out


def _flat(tree):
    from repro_torch.tree import tree_leaves

    return [t.detach().numpy() for t in tree_leaves(tree)]


def _cli(main, argv):
    buf = StringIO()
    with redirect_stdout(buf):
        main(argv)
    return np.array(buf.getvalue())


def run_rank(rank: int, rendezvous: str, inputs: str, outdir: str) -> None:
    """One rank of the module's process group: the jobs on this rank's rows,
    then the train and serve CLIs over ``--mesh single`` and ``--mesh
    multi``; outputs to ``outdir``."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.launch import train
    from repro_torch.serve import run as serve_run

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=180))
    data = dict(np.load(inputs))
    ax = D.ProcessGroupAxes({"data": WORLD}, "cpu")
    ax2 = D.ProcessGroupAxes({"pod": 2, "data": 2}, "cpu")
    assert ax.vshape(("data",)) == () and int(ax.index(("data",))) == rank
    assert int(ax2.index(("pod", "data"))) == rank and int(ax2.index(("data",))) == rank % 2

    def take(key):
        return torch.from_numpy(data["g2" if key == "g2_pods" else key][rank])

    res = jobs(D, ax, ax2, take, data)
    flat = {f"{name}/{i}": a for name, (tree, _, _) in res.items()
            for i, a in enumerate(_flat(tree))}
    flat["calls"] = np.array(json.dumps(dict(ax.calls)))
    for run, argv in TRAIN_RUNS.items():
        flat[f"train_{run}"] = _cli(train.main, TRAIN + [
            "--mesh", "single", "--ckpt", f"{outdir}/ckpt_{run}",
            "--ckpt-dir", f"{outdir}/snap_{run}"] + argv)
    flat["serve_single"] = _cli(serve_run.main, SERVE_CI + ["--mesh", "single"])
    os.environ["LOCAL_WORLD_SIZE"] = "2"  # two hosts of two ranks: (pod=2, data=2)
    flat["train_multi"] = _cli(train.main, TRAIN + ["--mesh", "multi", "--ckpt",
                                                    f"{outdir}/ckpt_multi"]
                               + TRAIN_RUNS["gather_median"])
    flat["serve_multi"] = _cli(serve_run.main, SERVE_CI + ["--mesh", "multi"])
    np.savez(f"{outdir}/rank{rank}.npz", **flat)
    dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """The 4 ranks and the reference's subprocess, started when the module
    starts (the tests that read neither run meanwhile): (inputs, the run
    directory, the processes)."""
    d = tmp_path_factory.mktemp("process_group")
    data = _inputs()
    np.savez(d / "in.npz", **data)
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=src)
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"),
                               str(d / "ref.npz")], env=ref_env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, os.path.join(ROOT, "tests"),
                                str(r), str(d / "rendezvous"), str(d / "in.npz"), str(d)],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True) for r in range(WORLD)]
    yield data, d, procs
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def ranks(_started, in_process):
    """(inputs, each rank's outputs, the run directory, the reference's
    outputs): waited for after the in-process jobs, which run while the
    processes do."""
    data, d, procs = _started
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for name, p, log in zip(["reference"] + [f"rank {r}" for r in range(WORLD)], procs, logs):
        assert p.returncode == 0, f"{name}: {log[-4000:]}"
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return data, outs, d, dict(np.load(d / "ref.npz"))


def _in_process(data):
    from repro_torch.core import distributed as D

    ax = D.InProcessAxes({"data": WORLD}, "cpu")
    ax2 = D.InProcessAxes({"pod": 2, "data": 2}, "cpu")

    def take(key):
        if key == "g2_pods":
            return torch.from_numpy(data["g2"]).reshape(2, 2, -1)
        return torch.from_numpy(data[key])

    return jobs(D, ax, ax2, take, data), ax


@pytest.fixture(scope="module")
def in_process(_started):
    return _in_process(_started[0])


def test_debug_mesh_snapshots_in_the_root():
    """The debug mesh keeps its snapshots in ``ckpt_dir`` itself; every rank
    of a process group in ``ckpt_dir/rank{r}``, a group of one rank too."""
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_debug_mesh(4, 1, device="cpu")
    assert mesh.snapshot_dir("s") == "s"
    pg = mesh_lib.Mesh(("data", "model"), (1, 1), torch.device("cpu"), mesh.axes, rank=0,
                       per_rank=True)
    assert pg.snapshot_dir("s") == os.path.join("s", "rank0")


def test_later_steps_still_raise(monkeypatch):
    from repro_torch.configs import ParallelConfig, get_smoke_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.optim.optimizers import get_optimizer

    # step 4 (tensor parallelism) is ported: the meshes take a model axis;
    # the production mesh now stops only at the missing process group
    tp = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    assert mesh_lib.mesh_shape_dict(tp) == {"data": 2, "model": 2}
    assert mesh_lib.num_workers(tp) == 2 and mesh_lib.model_size(tp) == 2
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.make_production_mesh(model=2, device="cpu")
    cfg = get_smoke_config("llama3.2-3b")
    opt = get_optimizer("adamw", 1e-3)
    # step 7 (fsdp and seq_parallel on the model axis, the codecs and
    # randomized attacks there) is ported: the step bodies build at model 2
    for pcfg in (ParallelConfig(param_mode="fsdp"), ParallelConfig(seq_parallel=True),
                 ParallelConfig(compression="int8")):
        assert steps.make_step_body(cfg, pcfg, tp, opt).waxes == ("data",)
    # step 6 (the ssm / rec layers and the frontends) is ported
    steps.make_step_body(get_smoke_config("mamba2-2.7b"), ParallelConfig(), tp, opt)
    # steps 5 and 8 (serving under tensor parallelism, a frontend
    # configuration's serving steps included) are ported
    steps.make_decode_pool_step(cfg, tp)
    steps.make_decode_pool_step(get_smoke_config("mamba2-2.7b"), tp)
    steps.make_decode_pool_step(get_smoke_config("whisper-small"), tp)
    mesh = mesh_lib.make_debug_mesh(2, 1, device="cpu")
    # step 3 (fsdp) is ported: it refuses what the reference's refuses
    with pytest.raises(ValueError, match="compression needs param_mode='replicated'"):
        steps.make_step_body(cfg, ParallelConfig(param_mode="fsdp", compression="int8"), mesh,
                             opt)
    with pytest.raises(ValueError, match="local_steps > 1 needs param_mode='replicated'"):
        trainer.make_window_step(cfg, ParallelConfig(param_mode="fsdp", local_steps=2), mesh,
                                 opt)


def test_production_mesh_without_a_group_names_torchrun(monkeypatch):
    from repro_torch.launch import mesh as mesh_lib

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.make_production_mesh(device="cpu")


def test_serve_cli_takes_the_reference_ci_smoke_flags():
    """The reference's CI serve smoke command (``--workers 2 --model-par
    1``), with ``--device cpu``: the mesh header and one sha256 on two runs;
    with ``--model-par 2`` it serves on the model axis, one sha256 on two
    runs too."""
    from repro_torch.serve import run as serve_run

    for model in ("1", "2"):
        argv = [a if a != "1" or SERVE_CI[i - 1] != "--model-par" else model
                for i, a in enumerate(SERVE_CI)]
        digests = []
        for _ in range(2):
            text = str(_cli(serve_run.main, argv))
            assert f"mesh debug workers=2 model_par={model}; device cpu" in text
            assert "served 24/24 requests" in text
            digests += _digests(text)
        assert len(digests) == 2 and digests[0] == digests[1]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                         b.view(np.uint8))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32).ravel(), np.asarray(b, np.float32).ravel()
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def _hold(got, want, exact, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if exact:
        assert _bits_equal(got, want), name
    elif name.startswith("attack_alie"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=MEAN_RTOL, atol=MEAN_ATOL, err_msg=name)


JOB_GROUPS = ["gather", "bucketed", "chunked", "coalesced", "psum", "rs", "minmax", "counts",
              "sums", "attack", "comp", "multi_axis", "hierarchical", "inner_gather", "bf16",
              "one_round", "local_update"]


def _names(want_all, group):
    names = [n for n in want_all if n == group or n.startswith(group + "_")]
    assert names, group
    return names


@pytest.mark.parametrize("group", JOB_GROUPS + ["codec"])
def test_process_group_matches_in_process(ranks, in_process, group):
    """Every job of the group, on every rank, against the in-process axes on
    the same rows: order statistics bitwise, backend sums to the mean
    tolerance, bin counts equal."""
    outs = ranks[1]
    want_all, _ = in_process
    for name in _names(want_all, group):
        tree, exact, varying = want_all[name]
        wants = _flat(tree)
        for r, out in enumerate(outs):
            for i, want in enumerate(wants):
                if varying == "pod":
                    want = want[r // 2]
                elif varying:
                    want = want[r]
                _hold(out[f"{name}/{i}"], want, exact, f"{name}/{i} rank {r}")


def _bin_width(rows, nbins=256):
    return (rows.max(0) - rows.min(0)) / nbins


def _lu_deltas(w, data):
    """The m accumulated local gradients of a local-update round from ``w``
    (numpy, (m, d))."""
    from repro_torch.core.robust_gd import linreg_loss
    from repro_torch.rounds.distributed import scan_local_sgd

    vg = torch.func.grad_and_value(linreg_loss)
    rows = []
    for i in range(WORLD):
        batch = (torch.from_numpy(data["x"][i]), torch.from_numpy(data["y"][i]))
        delta, _ = scan_local_sgd(lambda p: vg(p, batch)[::-1], torch.from_numpy(w), LU["tau"],
                                  LU["step_size"])
        rows.append(delta.numpy())
    return np.stack(rows)


def _hold_against_reference(name, i, got, want, data, ref):
    """One output leaf of a rank against the reference's, by the rules of
    the module's docstring."""
    msg = f"{name}/{i}"
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    strat = name.rsplit("_", 1)[-1]
    if name.startswith("chunked_"):
        g = data["g3"]
        if name == "chunked_mean":
            np.testing.assert_allclose(got, want, rtol=MEAN_RTOL, atol=MEAN_ATOL, err_msg=msg)
        elif name == "chunked_median":
            end = np.maximum(np.abs(g.min(0)), np.abs(g.max(0)))
            assert (np.abs(got - want) <= 2 * np.spacing(end)).all(), msg
        else:
            assert (np.abs(got - want) <= _bin_width(g, 512)).all(), msg
    elif name.endswith("_trimmed_mean"):
        assert _ulps(got, want) <= 1, msg
    elif name in ("psum", "gather_mean") or name.startswith("bucketed") and name.endswith("mean"):
        np.testing.assert_allclose(got, want, rtol=MEAN_RTOL, atol=MEAN_ATOL, err_msg=msg)
    elif name == "sums":
        np.testing.assert_allclose(got, want, rtol=MEAN_RTOL, atol=1e-6, err_msg=msg)
    elif name.startswith("attack_") and (strat in ("psum", "chunked")
                                         or name.startswith("attack_alie")):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=msg)
    elif name.startswith("one_round_") and strat == "chunked":
        rows = {"one_round_chunked": ref["solutions"], "one_round_replay_chunked": data["sol"],
                "one_round_replay_atk_chunked": _attacked_rows(data["sol"])}[name]
        slack = 1e-5 if name == "one_round_chunked" else 1e-7
        assert (np.abs(got - want) <= _bin_width(rows) + slack).all(), msg
    elif name.startswith("one_round_") and "replay" not in name:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=msg)
    elif name == "local_update_chunked":  # round i from the seeded iterate i
        width = _bin_width(_lu_deltas(data["w_iter"][i], data))
        assert (np.abs(got - want) <= LU["step_size"] * width + 1e-6).all(), msg
    elif name.startswith("local_update_"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=msg)
    else:
        assert _bits_equal(got, want), msg


def _attacked_rows(sol):
    """The replayed rows as the chunked sketch sees them under the round
    programs' sign_flip: the Byzantine workers' payloads."""
    from repro_torch.core import distributed as D
    from repro_torch.core.attacks import AttackConfig

    atk = AttackConfig("sign_flip", alpha=0.25, scale=10.0)
    return D._maybe_attack_chunked(D.InProcessAxes({"data": WORLD}, "cpu"),
                                   torch.from_numpy(sol), atk, ("data",), WORLD).numpy()


@pytest.mark.parametrize("group", JOB_GROUPS)
def test_process_group_matches_the_reference(ranks, in_process, group):
    """Every job of the group, on every rank, against the reference's
    shard_map program on the same rows (4 forced devices): the tolerances
    of the module's docstring."""
    data, outs, _, ref = ranks
    want_all, _ = in_process
    for name in _names(want_all, group):
        _, _, varying = want_all[name]
        n = sum(1 for k in outs[0] if k.startswith(name + "/"))
        assert n >= 1, name
        for r, out in enumerate(outs):
            for i in range(n):
                got = out[f"{name}/{i}"]
                if name == "inner_gather":  # a gather of the input rows within each pod
                    want = data["g2"].reshape(2, 2, -1)[r // 2]
                else:
                    want = ref[f"{name}/{i}"]
                    if varying:
                        want = want[r]
                _hold_against_reference(name, i, got, want, data, ref)


def test_collective_calls_are_counted_by_name(ranks, in_process):
    """The process group counts the collectives the in-process axes count,
    call for call."""
    outs = ranks[1]
    _, ax = in_process
    for out in outs:
        assert json.loads(str(out["calls"])) == dict(ax.calls)


def _losses(text):
    return [float(ln.split()[3]) for ln in text.splitlines() if ln.startswith("step ")]


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_train_cli_mesh_single_matches_the_debug_mesh(ranks, run, tmp_path):
    """Three steps of the smoke llama under ``--mesh single`` on 4 ranks
    against ``--mesh debug --workers 4``: the loss lines (rank 0 prints,
    the others print nothing) within the mean tolerance; the params
    bitwise for the gather median, within the mean tolerance for psum."""
    from repro_torch.launch import train

    _, outs, d, _ = ranks
    buf = StringIO()
    with redirect_stdout(buf):
        assert train.main(TRAIN + ["--mesh", "debug", "--workers", str(WORLD), "--ckpt",
                                   str(tmp_path / "ckpt")] + TRAIN_RUNS[run]) == 0
    want = buf.getvalue()
    got = str(outs[0][f"train_{run}"])
    assert "mesh={'data': 4, 'model': 1} workers=4" in got and "done: 3 steps" in got
    assert all(str(o[f"train_{run}"]) == "" for o in outs[1:])
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=0, atol=2e-4)
    assert len(_losses(got)) == 3
    # each rank snapshots its own state (its error-feedback residuals are its own)
    assert sorted(os.listdir(d / f"snap_{run}")) == [f"rank{r}" for r in range(WORLD)]
    files = sorted(f for f in os.listdir(tmp_path / "ckpt") if f.endswith(".npy"))
    assert files == sorted(f for f in os.listdir(d / f"ckpt_{run}") if f.endswith(".npy"))
    for f in files:
        a, b = np.load(d / f"ckpt_{run}" / f), np.load(tmp_path / "ckpt" / f)
        if run == "psum":
            np.testing.assert_allclose(a, b, rtol=MEAN_RTOL, atol=MEAN_ATOL, err_msg=f)
        else:
            assert np.array_equal(a, b), f


def test_train_cli_mesh_multi_is_mesh_single(ranks):
    """``--mesh multi`` on two hosts of two ranks, (pod=2, data=2): the gather
    median over both worker axes sees the rows in the same order as
    ``--mesh single``, so the params are bitwise the same."""
    _, outs, d, _ = ranks
    got = str(outs[0]["train_multi"])
    assert "mesh={'pod': 2, 'data': 2, 'model': 1} workers=4" in got
    assert _losses(got) == _losses(str(outs[0]["train_gather_median"]))
    files = sorted(f for f in os.listdir(d / "ckpt_multi") if f.endswith(".npy"))
    assert files
    for f in files:
        assert np.array_equal(np.load(d / "ckpt_multi" / f),
                              np.load(d / "ckpt_gather_median" / f)), f


def _digests(text):
    return [ln for ln in text.splitlines() if ln.startswith("final iterate sha256")]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_serve_cli_under_the_process_group(ranks, mesh):
    """The serve CLI with the reference's CI flags and ``--mesh single``
    (``multi``: two hosts of two ranks) on the 4 gloo ranks: rank 0 prints
    the header and the debug mesh's sha256, the other ranks nothing."""
    from repro_torch.serve import run as serve_run

    outs = ranks[1]
    want = _digests(str(_cli(serve_run.main, SERVE_CI)))
    got = str(outs[0][f"serve_{mesh}"])
    assert f"mesh {mesh} workers=2 model_par=1; device cpu" in got
    assert "served 24/24 requests" in got
    assert len(want) == 1 and _digests(got) == want
    assert all(str(o[f"serve_{mesh}"]) == "" for o in outs[1:])
