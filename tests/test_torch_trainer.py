"""The port's robust LM training (repro_torch.launch.steps' training half,
launch.trainer, launch.train, optim.schedules, data.make_lm_batch) on the
CPU, against the reference's trainer where it runs here.

The reference's ``make_window_step`` at ``device_steps=1`` runs in two
subprocesses (half the cells each, both started when the module starts, so
that the tests that do not read them run meanwhile) on
``make_debug_mesh(4, 1)`` over 4 forced CPU devices (its own tests'
harness) with replicated params (the model-axis sharding of its
``param_shardings`` makes the embedding gather raise ``ShardingTypeError``
in some JAX versions even at model size 1; the replicated window is the
same program), on tests/test_trainer.py's tiny llama in float32, for a
few (strategy, aggregator, attack) cells; it dumps its initial params, its
batches, per-step losses and grad norms and the final params.  The port
starts from the same params (``models.convert``) and runs its window on
the same batches with 4 in-process workers.

Tolerances, stated where used:
- against the reference over 4 steps: losses and grad norms within 1e-6
  relative, params within 1e-5 absolute (forward, backward and the worker
  sums run in different orders; observed up to 3e-7 and 6.5e-6; see CELLS
  for which cells step with SGD);
- within the port (window sizes, the hand-rolled loop, resume): bitwise;
- schedules: within 1 ulp of the reference's float32 values;
- ``make_lm_batch``: in distribution (the next-token rule holds for 90 % of
  tokens, within 0.02 over 8192 of them), its layout and label
  corruption exact.
"""
import dataclasses
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.optim import schedules as RS
from repro_torch import configs, rng
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, train, trainer
from repro_torch.models import convert
from repro_torch.optim import schedules
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.tree import tree_leaves, tree_leaves_with_path

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(name="trainer-test-tiny", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=172, vocab=128, dtype="float32")
DATA = dict(vocab=128, seq_len=16, global_batch=4, num_workers=4, seed=0)
STEPS = 4
LR = 1e-2
CELL_LR = {"adamw": LR, "sgd": 0.5}
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5

# name -> (optimizer, strategy, aggregator, attack, alpha, extra ParallelConfig
# fields).  The order-statistic cells under attack step with SGD: AdamW's
# first steps move a coordinate by about lr·sign(g), so wherever an
# aggregated coordinate is within rounding of 0 (the median or trimmed band
# of rows that straddle 0), a last-bit difference of the two packages'
# gradients becomes a difference of lr; AdamW runs in the other cells.
CELLS = {
    "gather_median_alie": ("sgd", "gather", "median", "alie", 0.25, {}),
    "bucketed_median_alie": ("sgd", "bucketed", "median", "alie", 0.25, {}),
    "gather_tm_signflip": ("sgd", "gather", "trimmed_mean", "sign_flip", 0.25, {}),
    "psum_mean_alie": ("adamw", "psum", "mean", "alie", 0.25, {}),
    "gather_median_topk": ("adamw", "gather", "median", "none", 0.0, {"compression": "topk"}),
    "bucketed_median_tau2": ("adamw", "bucketed", "median", "none", 0.0,
                             {"local_steps": 2, "local_lr": 0.1}),
}

REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
from repro.configs import llama3_2_3b
from repro.configs.base import ParallelConfig, TrainConfig
from repro.core.attacks import AttackConfig
from repro.data.pipeline import DataConfig, make_lm_batch
from repro.launch import mesh as mesh_lib, steps, trainer
from repro.optim.optimizers import get_optimizer
from jax.sharding import NamedSharding, PartitionSpec as P

# replicated params: with this jax the embed's model-axis sharding makes the
# gather raise ShardingTypeError even at model size 1
steps.param_shardings = lambda cfg, mesh: jax.tree.map(
    lambda _: NamedSharding(mesh, P()), steps.T.param_shapes(cfg),
    is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))

spec = json.loads(sys.argv[1])
cfg = dataclasses.replace(llama3_2_3b.smoke_config(), **spec["tiny"])
mesh = mesh_lib.make_debug_mesh(4, 1)
dcfg = DataConfig(**spec["data"])
out = {}

def dump(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)

opt = get_optimizer("adamw", spec["lr"]["adamw"], 0.0, 0.9)
dump("init/", trainer.init_state(cfg, mesh, opt, seed=0)["params"])
for i in range(spec["steps"]):
    b = make_lm_batch(dcfg, i, None)
    out[f"batch/{i}/tokens"] = np.asarray(b["tokens"])
    out[f"batch/{i}/labels"] = np.asarray(b["labels"])
for name, (optim, strategy, method, attack, alpha, extra) in spec["cells"].items():
    pcfg = ParallelConfig(agg_method=method, agg_strategy=strategy, agg_beta=0.25,
                          remat=False, **extra)
    tcfg = TrainConfig(optimizer=optim, lr=spec["lr"][optim], steps=spec["steps"],
                       device_steps=1)
    r = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg,
                           attack=AttackConfig(attack, alpha))
    out[f"{name}/loss"] = np.array([h["loss"] for h in r.history])
    out[f"{name}/grad_norm"] = np.array([h["grad_norm"] for h in r.history])
    dump(f"{name}/params/", r.state["params"])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _cfg():
    return dataclasses.replace(configs.get_smoke_config("llama3.2-3b"), **TINY)


def _mesh():
    return mesh_lib.make_debug_mesh(4, 1, device="cpu")


def _pcfg(strategy, method, extra):
    return ParallelConfig(agg_method=method, agg_strategy=strategy, agg_beta=0.25,
                          remat=False, **extra)


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


@pytest.fixture(scope="module", autouse=True)
def _ref_runs(tmp_path_factory):
    """The reference's cells in two subprocesses (each dumps the same
    initial params and batches), started when the module starts."""
    import json

    d = tmp_path_factory.mktemp("ref_trainer")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    names = list(CELLS)
    procs = []
    for i, half in enumerate((names[::2], names[1::2])):
        spec = {"tiny": TINY, "data": DATA, "lr": CELL_LR, "steps": STEPS,
                "cells": {k: list(CELLS[k]) for k in half}}
        procs.append((subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(spec), str(d / f"out{i}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            d / f"out{i}.npz"))
    yield procs
    for proc, _ in procs:
        proc.kill()


@pytest.fixture(scope="module")
def ref(_ref_runs):
    out = {}
    for proc, path in _ref_runs:
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log[-4000:]
        out.update(np.load(path))
    return out


def _port_run(ref, optim, strategy, method, attack, alpha, extra):
    """The port's window at device_steps=1 from the reference's params on
    the reference's batches: (losses, grad norms, final params)."""
    cfg, mesh = _cfg(), _mesh()
    pcfg = _pcfg(strategy, method, extra)
    opt = get_optimizer(optim, CELL_LR[optim], 0.0, 0.9)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    state["params"] = convert.transformer_from_reference(cfg, _nested(ref, "init/"), "cpu")
    state["opt_state"] = opt.init(state["params"])
    window = trainer.make_window_step(cfg, pcfg, mesh, opt, AttackConfig(attack, alpha), 1)
    losses, norms = [], []
    for i in range(STEPS):
        before = {k: float(v) for k, v in state["metrics"].items()}
        batch = {k: torch.from_numpy(ref[f"batch/{i}/{k}"])[None] for k in ("tokens", "labels")}
        state = window(state, batch)
        met = trainer.window_metrics(before, state)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
    return np.array(losses), np.array(norms), state["params"]


def _final(ds, attack, strategy="bucketed", method="median", steps=4, **extra):
    cfg = _cfg()
    tcfg = TrainConfig(optimizer="adamw", lr=LR, steps=steps, device_steps=ds)
    r = trainer.train_loop(cfg, _pcfg(strategy, method, extra), tcfg, _mesh(),
                           dcfg=pipeline.DataConfig(**DATA), attack=attack)
    assert int(r.state["step"]) == steps and int(r.state["metrics"]["micro_steps"]) == steps
    return r


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("attack,strategy", [("alie", "bucketed"), ("gauss", "gather")])
def test_window_size_invariance_and_attack_key_folding(attack, strategy):
    """ds 1 and 4 give the same params bit for bit, under ALIE and under the
    randomized gauss attack (its key folds the GLOBAL step index); the
    clean run differs (the attack runs inside the window)."""
    atk = AttackConfig(attack, 0.25)
    p1 = _final(1, atk, strategy).state["params"]
    p4 = _final(4, atk, strategy).state["params"]
    assert _equal(p1, p4)
    assert not _equal(p4, _final(4, None, strategy).state["params"])


def test_ds1_bitwise_equals_handrolled_step_loop():
    """The window at device_steps=1 is a hand-rolled loop over the same
    step body, bit for bit."""
    cfg, mesh = _cfg(), _mesh()
    attack = AttackConfig("sign_flip", 0.25)
    pcfg = _pcfg("bucketed", "median", {})
    opt = get_optimizer("adamw", LR, 0.0, 0.9)
    r = _final(1, attack)
    sb = steps.make_step_body(cfg, pcfg, mesh, opt, attack)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    params, opt_state = state["params"], state["opt_state"]
    dcfg = pipeline.DataConfig(**DATA)
    for i in range(4):
        batch = pipeline.make_lm_batch(dcfg, i, attack, device="cpu")
        params, opt_state, _ = sb.body(params, opt_state, batch, i, 0)
    assert _equal(r.state["params"], params)
    step = steps.make_train_step(cfg, pcfg, mesh, opt, attack)
    p2, o2 = state["params"], state["opt_state"]
    for i in range(4):
        p2, o2, _ = step(p2, o2, pipeline.make_lm_batch(dcfg, i, attack, device="cpu"), i)
    assert _equal(p2, params)


def test_resume_from_a_snapshot_is_bitwise(tmp_path):
    """Snapshots every window; resuming from the step-2 one replays the rest
    of the run bit for bit (state, metric sums and history)."""
    cfg = _cfg()
    pcfg = _pcfg("gather", "trimmed_mean", {"compression": "topk"})
    tcfg = TrainConfig(optimizer="adamw", lr=LR, steps=6, device_steps=2)
    dcfg = pipeline.DataConfig(**DATA)
    atk = AttackConfig("gauss", 0.25)
    full = trainer.train_loop(cfg, pcfg, tcfg, _mesh(), dcfg=dcfg, attack=atk,
                              ckpt_every=1, ckpt_dir=str(tmp_path))
    resumed = trainer.train_loop(cfg, pcfg, tcfg, _mesh(), dcfg=dcfg, attack=atk,
                                 ckpt_dir=str(tmp_path), resume=2)
    assert _equal(full.state, resumed.state)
    assert [h["loss"] for h in full.history] == [h["loss"] for h in resumed.history]


def test_error_feedback_topk_threads_the_residual():
    """topk through comp_body: per-worker residuals of the parameter count
    ride the state and change the trajectory; the stateless train step
    rejects the codec."""
    cfg, mesh = _cfg(), _mesh()
    pcfg = _pcfg("gather", "median", {"compression": "topk"})
    opt = get_optimizer("adamw", LR, 0.0, 0.9)
    assert steps.make_step_body(cfg, pcfg, mesh, opt).comp_body is not None
    r = _final(2, None, "gather", compression="topk")
    comp = r.state["comp"]
    assert comp.shape == (4, steps.comp_state_size(cfg)) and comp.abs().sum() > 0
    clean = _final(2, None, "gather")
    assert not _equal(r.state["params"], clean.state["params"])
    with pytest.raises(ValueError, match="error-feedback"):
        steps.make_train_step(cfg, pcfg, mesh, opt)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 99, 100, 250])
def test_schedules_match_the_reference(step):
    pairs = ((schedules.constant(3e-4), RS.constant(3e-4)),
             (schedules.cosine(1e-3, 10, 100), RS.cosine(1e-3, 10, 100)),
             (schedules.cosine(1e-3, 0, 100, 0.0), RS.cosine(1e-3, 0, 100, 0.0)),
             (schedules.inverse_sqrt(1e-3, 10), RS.inverse_sqrt(1e-3, 10)))
    for got, want in pairs:
        g = np.float32(got(step).item())
        w = np.float32(want(step))
        assert abs(int(g.view(np.int32)) - int(w.view(np.int32))) <= 1, (step, g, w)


def test_make_lm_batch_in_distribution_and_its_label_corruption():
    cfg = pipeline.DataConfig(vocab=97, seq_len=64, global_batch=128,
                              num_workers=4, seed=3)
    b = pipeline.make_lm_batch(cfg, 5, None, device="cpu")
    tok, lab = b["tokens"], b["labels"]
    assert tok.shape == lab.shape == (128, 64) and tok.dtype == lab.dtype == torch.int32
    assert int(tok.min()) >= 0 and int(tok.max()) < 97
    assert torch.equal(tok[:, 1:], lab[:, :-1])  # one stream, shifted
    rule = ((5 * tok.long() + 7) % 97 == lab.long()).float().mean().item()
    assert abs(rule - 0.9) < 0.02, rule
    # worker w's rows come from the generator of (seed, step, w)
    w2 = lm_batch(rng.generator(3, 5, 2), 32, 64, 97, device="cpu")
    assert torch.equal(tok[64:96], w2["tokens"]) and torch.equal(lab[64:96], w2["labels"])
    assert torch.equal(b["tokens"], pipeline.make_lm_batch(cfg, 5, None, device="cpu")["tokens"])
    assert not torch.equal(tok, pipeline.make_lm_batch(cfg, 6, None, device="cpu")["tokens"])
    flip = pipeline.make_lm_batch(cfg, 5, AttackConfig("label_flip", 0.25), device="cpu")
    assert torch.equal(flip["tokens"], tok)
    assert torch.equal(flip["labels"][:32], 9 - lab[:32])  # num_classes 10, worker 0
    assert torch.equal(flip["labels"][32:], lab[32:])
    rand = pipeline.make_lm_batch(cfg, 5, AttackConfig("random_label", 0.5), device="cpu")
    assert torch.equal(rand["labels"][64:], lab[64:])
    assert int(rand["labels"][:64].max()) < 10 and not torch.equal(rand["labels"][:64],
                                                                  lab[:64])
    gen = rng.generator(3, 5, 1, 999)
    want = torch.randint(0, 10, (32, 64), generator=gen, dtype=torch.int32)
    assert torch.equal(rand["labels"][32:64], want)


def test_rejections():
    cfg, mesh = _cfg(), _mesh()
    opt = get_optimizer("adamw", LR)
    # the model axis builds (tensor parallelism), fsdp and seq_parallel on
    # it too (step 7)
    tp = mesh_lib.make_debug_mesh(4, 2, device="cpu")
    assert mesh_lib.mesh_shape_dict(tp) == {"data": 4, "model": 2}
    assert mesh_lib.num_workers(tp) == 4 and mesh_lib.worker_axes(tp) == ("data",)
    steps.make_step_body(cfg, ParallelConfig(), tp, opt)
    for pcfg in (ParallelConfig(param_mode="fsdp"), ParallelConfig(seq_parallel=True)):
        assert steps.make_step_body(cfg, pcfg, tp, opt).waxes == ("data",)
    # the ssm / rec layers and the frontends train on it (step 6)
    steps.make_step_body(configs.get_smoke_config("mamba2-2.7b"), ParallelConfig(), tp, opt)
    steps.make_step_body(configs.get_smoke_config("whisper-small"), ParallelConfig(), tp, opt)
    with pytest.raises(ValueError, match="randomized"):  # fsdp: no per-step attack key
        steps.make_step_body(cfg, ParallelConfig(param_mode="fsdp"), mesh, opt,
                             AttackConfig("gauss", 0.25))
    with pytest.raises(ValueError, match="adaptive"):
        steps.make_step_body(cfg, ParallelConfig(), mesh, opt, AttackConfig("stale", 0.25))
    with pytest.raises(ValueError, match="needs"):
        steps.make_step_body(cfg, ParallelConfig(agg_strategy="chunked"), mesh, opt,
                             AttackConfig("mimic", 0.25))
    with pytest.raises(ValueError, match="multiple of device_steps"):
        trainer.train_loop(cfg, ParallelConfig(), TrainConfig(steps=5, device_steps=2), mesh)
    with pytest.raises(ValueError, match="local_steps"):
        steps.make_step_body(cfg, ParallelConfig(local_steps=0), mesh, opt)
    vision = dataclasses.replace(cfg, frontend="vision", n_frontend_tokens=2)
    sb = steps.make_step_body(vision, ParallelConfig(), mesh, opt)
    with pytest.raises(ValueError, match="frontend needs its embeddings"):
        params = trainer.init_state(vision, mesh, opt)["params"]
        sb.body(params, opt.init(params), {k: v[0] for k, v in trainer.stack_window_batches(
            pipeline.DataConfig(**DATA), 0, 1, mesh).items()}, 0, 0)
    for arch in ("recurrentgemma-2b", "internvl2-1b"):  # rec layers; a frontend
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert train.main(["--config", arch, "--smoke", "--device", "cpu", "--model-par",
                               "2", "--steps", "2", "--seq-len", "16", "--global-batch",
                               "4"]) == 0
        assert "'model': 2}" in buf.getvalue() and "done: 2 steps" in buf.getvalue()


def test_hierarchical_window_on_pods():
    """The trainer's step over a (pod, data) worker axis: hierarchical
    median of medians, one step, finite and moving."""
    cfg = _cfg()
    mesh = mesh_lib.make_debug_mesh(2, 1, pod=2, device="cpu")
    assert mesh_lib.num_workers(mesh) == 4 and mesh_lib.worker_axes(mesh) == ("pod", "data")
    opt = get_optimizer("adamw", LR)
    pcfg = _pcfg("hierarchical", "median", {})
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    before = state["params"]["embed"].clone()
    window = trainer.make_window_step(cfg, pcfg, mesh, opt, AttackConfig("alie", 0.25), 1)
    batches = trainer.stack_window_batches(pipeline.DataConfig(**DATA), 0, 1, mesh)
    state = window(state, batches)
    assert torch.isfinite(state["metrics"]["loss_sum"]) and \
        not torch.equal(state["params"]["embed"], before)


def test_cli_trains_end_to_end():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = train.main(["--device", "cpu", "--config", "llama3.2-3b", "--smoke", "--steps", "4",
                         "--device-steps", "2", "--workers", "4", "--seq-len", "32",
                         "--global-batch", "4", "--strategy", "bucketed", "--agg", "median",
                         "--attack", "alie", "--attack-alpha", "0.25"])
    out = buf.getvalue()
    assert rc == 0
    assert "workers=4 device_steps=2 device cpu" in out
    assert sum(line.startswith("step ") for line in out.splitlines()) == 2
    assert "done: 4 steps in windows of 2" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("cell", list(CELLS))
def test_window_ds1_matches_the_reference(ref, cell):
    losses, norms, params = _port_run(ref, *CELLS[cell])
    np.testing.assert_allclose(losses, ref[f"{cell}/loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, ref[f"{cell}/grad_norm"], rtol=LOSS_RTOL)
    want = _nested(ref, f"{cell}/params/")
    for path, t in tree_leaves_with_path(params):
        w = want
        for p in path.split("/"):
            w = w[p]
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=PARAM_ATOL, err_msg=path)
    init = _nested(ref, "init/")
    assert not np.array_equal(params["embed"].numpy(), init["embed"])  # it trained
