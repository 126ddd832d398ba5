"""Sequence parallelism in the port (``ParallelConfig.seq_parallel`` at a
mesh's ``model`` > 1): between the layers of a super-block the residual
stream is split over ``model`` along S (``models/sharding.ShardCtx``,
``seq_ok``: even, or uneven with padding when 2·S >= model, else whole),
each block norm runs on a rank's rows (``transformer._rows_norm``: its
scale's gradient summed over the whole rows), and the model-axis
boundaries are Megatron-SP's pair (``Collectives.seq_enter``:
an all-gather whose backward is a reduce-scatter; ``seq_reduce``: a
reduce-scatter whose backward is an all-gather; under a process group
both built from an all-reduce and the rank's chunk, as gloo has no
reduce-scatter).

The contract: ``seq_parallel=True`` is bitwise ``seq_parallel=False`` with
the blocks' norms run in the same per-rank form (the test patches it into
the run without: :func:`rows_norms`; the program's own path without
sequence parallelism norms the whole residual, whose autograd adds the
residual's gradients in another order), for every family, in process and
on 4 gloo ranks at (data 2, model 2) (and at (data 1, model 4), where S = 1
stays whole), composed with fsdp and remat; against the program's own
path without it, within rounding; at model 1 it is the reference's step.  The reference runs its step once
in a subprocess on 4 forced CPU devices (replicated params, as
tests/test_torch_tp.py's does); the gloo ranks are spawned once for the
module (a ``file://`` rendezvous, every join with a timeout) and run
:func:`jobs` while the in-process tests run.  About 45 s serially.

Tolerances, stated where used:
- seq_parallel against without (its norms per rank, :func:`rows_norms`),
  and the gloo ranks against the in-process run: bitwise (params, each
  rank's shards; losses; grad norms);
- seq_parallel against the program's path without it (the whole
  residual's norms): losses and grad norms 1e-6 relative, params 1e-5
  absolute (2 SGD steps, f32, as the (1, 4) cell);
- model 1 against the reference's step (f32, 2 SGD steps from the
  reference's params on its batches), and the (1, 4) ranks against the
  in-process (1, 4) run (2 SGD steps; four partial sums in the backend's
  order): losses and grad norms 1e-6 relative, params 1e-5 absolute
  (tests/test_torch_trainer.py's).
"""
import contextlib
import dataclasses
import json
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
from repro_torch.models import convert, sharding
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.tree import tree_leaves_with_path

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
STEPS = 2
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
# (config, seq_len, ParallelConfig overrides) at (2, 2)
CELLS = {
    "llama": ("llama3.2-3b", 16, {}),
    "granite": ("granite-moe-1b-a400m", 16, {}),
    "mamba2": ("mamba2-2.7b", 16, {}),
    "recurrentgemma": ("recurrentgemma-2b", 16, {}),
    "whisper": ("whisper-small", 16, {}),
    "uneven": ("llama3.2-3b", 15, {}),  # 15 rows over 2 ranks: 8 and 7 (padded)
    "fsdp_remat": ("llama3.2-3b", 16, {"param_mode": "fsdp", "remat": True}),
}
WHOLE_CELL = ("llama3.2-3b", 1)  # at (1, 4): 2·1 < 4, the residual stays whole
# SGD there: the ranks' four partial sums meet in the backend's order, and
# AdamW would turn a last-bit difference into a move of lr
WHOLE_OPT = ("sgd", SGD_LR := 0.5)
# tests/test_dryrun_lite.py's lowering case: llama smoke at (4, 2), median,
# remat, attn_chunk 16, seq 64, batch 8
LOWERING = dict(seq_len=64, global_batch=8, attn_chunk=16)
TINY = dict(name="trainer-test-tiny", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=172, vocab=128, dtype="float32")
REF_DATA = dict(vocab=128, seq_len=16, global_batch=4, num_workers=4, seed=0)

RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_seq_parallel as T
T.run_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
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
mesh = mesh_lib.make_debug_mesh(4, 1)
out = {}

def dump(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)

dump("init/", trainer.init_state(cfg, mesh, get_optimizer("sgd", spec["lr"]), seed=0)["params"])
for i in range(spec["steps"]):
    b = make_lm_batch(dcfg, i, None)
    out[f"batch/{i}/tokens"] = np.asarray(b["tokens"])
    out[f"batch/{i}/labels"] = np.asarray(b["labels"])
pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25, remat=False,
                      seq_parallel=True)
tcfg = TrainConfig(optimizer="sgd", lr=spec["lr"], steps=spec["steps"], device_steps=1)
r = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=AttackConfig("alie", 0.25))
out["loss"] = np.array([h["loss"] for h in r.history])
out["grad_norm"] = np.array([h["grad_norm"] for h in r.history])
dump("params/", r.state["params"])
np.savez(sys.argv[2], **out)
print("OK")
"""


@contextlib.contextmanager
def rows_norms():
    """Without seq_parallel, the blocks' norms a model rank's rows at a time,
    the form seq_parallel runs them in (``transformer._rows_norm``), so that
    the two runs take the same autograd paths: the runs seq_parallel is
    held bitwise against."""
    from repro_torch.models import transformer as T

    real = T._norm
    T._norm = lambda ctx, x, w, eps: (T._rows_norm(ctx, x, w, eps) if ctx.seq_len
                                      else real(ctx, x, w, eps))
    try:
        yield
    finally:
        T._norm = real


def _cfg(arch):
    return dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")


def _run(arch, seq, over, mesh, sp, global_batch=4, attn_chunk=0, remat=False,
         opt=("adamw", 1e-2)):
    cfg = _cfg(arch)
    over = dict(over)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          attn_chunk=attn_chunk, seq_parallel=sp,
                          remat=over.pop("remat", remat), **over)
    m = mesh_lib.num_workers(mesh)
    r = trainer.train_loop(cfg, pcfg, TrainConfig(optimizer=opt[0], lr=opt[1], steps=STEPS,
                                                  device_steps=1), mesh,
                           dcfg=pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq,
                                                    global_batch=global_batch, num_workers=m,
                                                    seed=0),
                           attack=AttackConfig("alie", 0.25))
    return {"params": {p: t.detach().numpy().copy()
                       for p, t in tree_leaves_with_path(r.state["params"])},
            "loss": np.array([h["loss"] for h in r.history]),
            "grad_norm": np.array([h["grad_norm"] for h in r.history])}


def jobs(mesh, whole_mesh):
    """The cells with seq_parallel on ``mesh`` (data 2, model 2) and the
    whole-S cell on ``whole_mesh`` (data 1, model 4)."""
    out = {cell: _run(arch, seq, over, mesh, True) for cell, (arch, seq, over) in CELLS.items()}
    for sp in (True, False):
        out["whole" if sp else "whole_off"] = _run(*WHOLE_CELL, {}, whole_mesh, sp,
                                                    global_batch=2, opt=WHOLE_OPT)
    return out


def run_rank(rank: int, rendezvous: str, outdir: str) -> None:
    """One rank of the module's process group: the (2, 2) cells, then the
    whole-S cell on a (1, 4) mesh over the same world."""
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    mesh = mesh_lib.make_production_mesh(model=2, device="cpu")
    whole = mesh_lib.make_production_mesh(model=4, device="cpu")
    flat = {}
    for cell, out in jobs(mesh, whole).items():
        flat[f"{cell}/loss"], flat[f"{cell}/grad_norm"] = out["loss"], out["grad_norm"]
        for p, v in out["params"].items():
            flat[f"{cell}/params/{p}"] = v
    np.savez(f"{outdir}/rank{rank}.npz", **flat)
    dist.destroy_process_group()


def _spawn(cmd, env):
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The reference's step and the 4 gloo ranks, started once for the
    module."""
    d = tmp_path_factory.mktemp("sp")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    spec = {"tiny": TINY, "data": REF_DATA, "lr": SGD_LR, "steps": STEPS}
    started = {"ref": _spawn([sys.executable, "-c", REF_STEP_SCRIPT, json.dumps(spec),
                              str(d / "ref.npz")],
                             dict(env, JAX_PLATFORMS="cpu",
                                  XLA_FLAGS="--xla_force_host_platform_device_count=4"))}
    for r in range(WORLD):
        started[f"rank {r}"] = _spawn([sys.executable, "-c", RANK_SCRIPT,
                                       os.path.join(ROOT, "tests"), str(r),
                                       str(d / "rendezvous"), str(d)], env)
    done = {}

    def wait(name):
        if name not in done:
            log = started[name].communicate(timeout=300)[0]
            assert started[name].returncode == 0, f"{name}: {log[-4000:]}"
            done[name] = True
        return d

    yield wait
    for p in started.values():
        p.kill()


@pytest.fixture(scope="module")
def rank_outs(procs):
    d = None
    for r in range(WORLD):
        d = procs(f"rank {r}")
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def in_process(procs):
    """Every cell with and without seq_parallel in process (run while the
    ranks do): {(cell, sp): run}."""
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    whole = mesh_lib.make_debug_mesh(1, 4, device="cpu")
    out = {}
    for sp in (False, True):
        with rows_norms() if not sp else contextlib.nullcontext():
            for cell, (arch, seq, over) in CELLS.items():
                out[(cell, sp)] = _run(arch, seq, over, mesh, sp)
            out[("whole", sp)] = _run(*WHOLE_CELL, {}, whole, sp, global_batch=2,
                                      opt=WHOLE_OPT)
    for sp in (False, True):  # SGD: AdamW's step would turn rounding into moves of lr
        out[("llama", "sgd", sp)] = _run(*CELLS["llama"], mesh, sp, opt=WHOLE_OPT)
    return out


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                         b.view(np.uint8))


def _same_run(a, b):
    assert _bits_equal(a["loss"], b["loss"]), (a["loss"], b["loss"])
    assert _bits_equal(a["grad_norm"], b["grad_norm"]), (a["grad_norm"], b["grad_norm"])
    assert a["params"].keys() == b["params"].keys()
    for path, v in a["params"].items():
        assert _bits_equal(v, b["params"][path]), path


# ---------------------------------------------------------------------------
# (a) the split rule and the collectives
# ---------------------------------------------------------------------------


def test_seq_ok_is_the_references_rule():
    """Even, or uneven when at least half the shards are non-empty; at
    model 1 nothing splits."""
    from repro.models.sharding import ShardCtx as RefCtx

    for model in (1, 2, 3, 4, 8):
        ref = RefCtx(model_axes=("model",), mesh_shape={"model": model})
        for s in (1, 2, 3, 4, 7, 15, 16, 64):
            assert sharding.seq_ok(s, model) == (model > 1 and ref._ok(s, ("model",))), (s, model)
    assert not sharding.seq_ok(1, 4) and sharding.seq_ok(15, 2) and sharding.seq_ok(3, 4)


@pytest.mark.parametrize("n", [8, 7, 1])
def test_in_process_seq_reduce_is_the_sum_in_rank_order(n):
    """``InProcessAxes.seq_reduce``: each rank's chunk of rows in turn, the
    partials summed in rank order, is bitwise the rank-order sum; the
    other three boundaries are the global view itself."""
    g = torch.Generator().manual_seed(n)
    parts = [torch.randn((2, n, 5), generator=g) for _ in range(2)]
    ax = D.InProcessAxes({"data": 1, "model": 2}, "cpu")
    assert torch.equal(ax.seq_reduce(parts, 1, n), parts[0] + parts[1])
    x = parts[0]
    assert ax.model_cut(x, 1) is x and ax.model_full(x, 1, n) is x
    assert torch.equal(ax.seq_enter(x, 1, n), x)


def test_serving_and_the_encoder_never_split_the_sequence():
    """The serving context drops seq_parallel, as the reference's
    ``_serve_ctx``: prefill at (2, 2) with a seq_parallel context is the
    one without."""
    cfg = _cfg("llama3.2-3b")
    from repro_torch.models import transformer as T

    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    params = T.init_params(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(0))
    want = T.prefill(params, tokens, cfg, ctx=sharding.model_ctx(mesh))
    got = T.prefill(params, tokens, cfg, ctx=sharding.model_ctx(mesh, seq_parallel=True))
    assert torch.equal(got[0], want[0])
    assert sharding.model_ctx(mesh_lib.make_debug_mesh(4, 1, device="cpu"), True) is \
        sharding.NULL_CTX


# ---------------------------------------------------------------------------
# (b) bitwise seq_parallel=False, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS) + ["whole"])
def test_seq_parallel_is_bitwise_without_it_in_process(in_process, cell):
    _same_run(in_process[(cell, True)], in_process[(cell, False)])


def test_seq_parallel_is_within_rounding_of_the_whole_residuals_norms(in_process):
    """Against the program's own path without seq_parallel (every block
    norm on the whole residual, no per-rank form): the same function, so
    the runs agree to rounding; the per-rank form does change the bits,
    which is why the bitwise holds patch it into the run without."""
    got, want = in_process[("llama", "sgd", True)], in_process[("llama", "sgd", False)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL)
    for path, v in got["params"].items():
        np.testing.assert_allclose(v, want["params"][path], rtol=0, atol=PARAM_ATOL,
                                   err_msg=path)


def test_the_reference_lowering_case_in_process():
    """tests/test_dryrun_lite.py's seq-parallel case as a run: llama smoke
    at (4, 2), median, remat, attn_chunk 16, seq 64, batch 8; seq_parallel
    bitwise without it."""
    mesh = mesh_lib.make_debug_mesh(4, 2, device="cpu")
    runs = []
    for sp in (False, True):
        with rows_norms() if not sp else contextlib.nullcontext():
            runs.append(_run("llama3.2-3b", LOWERING["seq_len"], {}, mesh, sp,
                             global_batch=LOWERING["global_batch"],
                             attn_chunk=LOWERING["attn_chunk"], remat=True))
    _same_run(runs[1], runs[0])
    assert np.isfinite(runs[1]["loss"]).all()


def test_seq_parallel_at_model_one_matches_the_reference(procs):
    """At model 1 the context drops sequence parallelism (a constraint over a
    size-1 axis is a no-op), and the step is the reference's with it on:
    2 SGD steps of the tiny llama at (4, 1) from the reference's params."""
    ref = dict(np.load(procs("ref") / "ref.npz"))

    def nested(prefix):
        tree = {}
        for key, v in ref.items():
            if key.startswith(prefix):
                node = tree
                parts = key[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = v
        return tree

    cfg = dataclasses.replace(configs.get_smoke_config("llama3.2-3b"), **TINY)
    mesh = mesh_lib.make_debug_mesh(4, 1, device="cpu")
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          remat=False, seq_parallel=True)
    opt = get_optimizer("sgd", SGD_LR)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    state["params"] = convert.transformer_from_reference(cfg, nested("init/"), "cpu")
    state["opt_state"] = opt.init(state["params"])
    window = trainer.make_window_step(cfg, pcfg, mesh, opt, AttackConfig("alie", 0.25), 1)
    losses, norms = [], []
    for i in range(STEPS):
        before = {k: float(v) for k, v in state["metrics"].items()}
        batch = {k: torch.from_numpy(ref[f"batch/{i}/{k}"])[None] for k in ("tokens", "labels")}
        state = window(state, batch)
        met = trainer.window_metrics(before, state)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
    np.testing.assert_allclose(losses, ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, ref["grad_norm"], rtol=LOSS_RTOL)
    want = nested("params/")
    for path, t in tree_leaves_with_path(state["params"]):
        w = want
        for p in path.split("/"):
            w = w[p]
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=PARAM_ATOL, err_msg=path)


# ---------------------------------------------------------------------------
# (c) the gloo ranks: the residual really split, the same bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS))
def test_gloo_ranks_are_bitwise_the_in_process_run(rank_outs, in_process, cell):
    """Each rank's params are its shards of the in-process run's (its
    model chunk, and under fsdp its worker chunk of it), its losses and
    grad norms the in-process run's, bitwise: with seq_parallel the ranks
    hold their rows of the residual only."""
    arch, model = CELLS[cell][0], 2
    fsdp = CELLS[cell][2].get("param_mode") == "fsdp"
    cfg = _cfg(arch)
    mesh = mesh_lib.make_debug_mesh(WORLD // model, model, device="cpu")
    tdims = dict(tree_leaves_with_path(sharding.tp_dims(cfg, model)))
    fdims = dict(tree_leaves_with_path(steps.fsdp_dims(cfg, mesh))) if fsdp else {}
    mdims = dict(tree_leaves_with_path(steps.fsdp_model_dims(cfg, mesh))) if fsdp else tdims
    glob = in_process[(cell, True)]
    for r, out in enumerate(rank_outs):
        w, k = divmod(r, model)
        for path, v in glob["params"].items():
            t = torch.from_numpy(v)
            if mdims[path] >= 0:
                t = t.chunk(model, mdims[path])[k]
            if fsdp and fdims[path] >= 0:
                t = t.chunk(WORLD // model, fdims[path])[w]
            assert _bits_equal(out[f"{cell}/params/{path}"], t.numpy()), (r, path)
        assert _bits_equal(out[f"{cell}/loss"], glob["loss"])
        if fsdp:
            np.testing.assert_allclose(out[f"{cell}/grad_norm"], glob["grad_norm"],
                                       rtol=LOSS_RTOL)
        else:
            assert _bits_equal(out[f"{cell}/grad_norm"], glob["grad_norm"])


def test_gloo_ranks_keep_an_unsplit_residual_whole(rank_outs, in_process):
    """At (data 1, model 4) S = 1 does not split (2·1 < 4): on every rank
    seq_parallel is bitwise without it; the four partial sums of model 4
    meet in the backend's order, so against the in-process run the params
    agree to PARAM_ATOL and the losses to LOSS_RTOL."""
    cfg = _cfg(WHOLE_CELL[0])
    tdims = dict(tree_leaves_with_path(sharding.tp_dims(cfg, 4)))
    glob = in_process[("whole", True)]
    for r, out in enumerate(rank_outs):
        for key in [k for k in out if k.startswith("whole/")]:
            assert _bits_equal(out[key], out["whole_off/" + key[len("whole/"):]]), (r, key)
        for path, v in glob["params"].items():
            t = torch.from_numpy(v)
            if tdims[path] >= 0:
                t = t.chunk(4, tdims[path])[r]
            np.testing.assert_allclose(out[f"whole/params/{path}"], t.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{r} {path}")
        np.testing.assert_allclose(out["whole/loss"], glob["loss"], rtol=LOSS_RTOL)
