"""The port's robust LM training (launch.steps / trainer / train) on the MoE,
SSM and hybrid families, on the CPU.

The reference's ``make_window_step`` at ``device_steps=1`` runs in one
subprocess per family, the three started when the module starts (the CLI
tests run meanwhile), on ``make_debug_mesh(4, 1)`` (4 forced CPU devices,
replicated params; tests/test_torch_trainer.py's harness) for mamba2,
granite and
recurrentgemma (its unrolled tail) at smoke width in float32: 2 steps of SGD 0.5, gather median under ALIE
alpha 0.25 (granite's loss carries the 0.01-weighted MoE aux loss).  The
port runs its window from the same params on the same batches with 4
in-process workers.  Tolerances (tests/test_torch_trainer.py's): losses
and grad norms 1e-6 relative, params 1e-5 absolute.
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

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.core import aggregators
from repro_torch.core.attacks import AttackConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train, trainer
from repro_torch.models import convert
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.tree import tree_leaves_with_path

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mamba2_2_7b", "granite_moe_1b_a400m", "recurrentgemma_2b")
STEPS, LR = 2, 0.5
DATA = dict(seq_len=16, global_batch=4, num_workers=4, seed=0)

REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ParallelConfig, TrainConfig
from repro.core.attacks import AttackConfig
from repro.data.pipeline import DataConfig, make_lm_batch
from repro.launch import mesh as mesh_lib, steps, trainer
from repro.optim.optimizers import get_optimizer
from jax.sharding import NamedSharding, PartitionSpec as P

# replicated params (tests/test_torch_trainer.py's reason)
steps.param_shardings = lambda cfg, mesh: jax.tree.map(
    lambda _: NamedSharding(mesh, P()), steps.T.param_shapes(cfg),
    is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))

spec = json.loads(sys.argv[1])
mesh = mesh_lib.make_debug_mesh(4, 1)
out = {}

def dump(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = (
            np.asarray(leaf))

for arch in spec["archs"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    dcfg = DataConfig(vocab=cfg.vocab, **spec["data"])
    opt = get_optimizer("sgd", spec["lr"])
    dump(f"{arch}/init/", trainer.init_state(cfg, mesh, opt, seed=0)["params"])
    for i in range(spec["steps"]):
        b = make_lm_batch(dcfg, i, None)
        out[f"{arch}/batch/{i}/tokens"] = np.asarray(b["tokens"])
        out[f"{arch}/batch/{i}/labels"] = np.asarray(b["labels"])
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          remat=False)
    tcfg = TrainConfig(optimizer="sgd", lr=spec["lr"], steps=spec["steps"], device_steps=1)
    r = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=AttackConfig("alie", 0.25))
    out[f"{arch}/loss"] = np.array([h["loss"] for h in r.history])
    out[f"{arch}/grad_norm"] = np.array([h["grad_norm"] for h in r.history])
    dump(f"{arch}/params/", r.state["params"])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _nested(flat, prefix):
    """The tree under ``prefix`` of the reference's flat leaves; a node whose
    keys are all indices (the tail) becomes a list."""
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


@pytest.fixture(scope="module", autouse=True)
def _ref_runs(tmp_path_factory):
    """The reference's window, one subprocess per family, started when the
    module starts."""
    d = tmp_path_factory.mktemp("ref_families_train")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for arch in ARCHS:
        spec = {"archs": [arch], "data": DATA, "lr": LR, "steps": STEPS}
        procs[arch] = subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, json.dumps(spec), str(d / f"{arch}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield procs, d
    for proc in procs.values():
        proc.kill()


@pytest.fixture(scope="module")
def ref(_ref_runs):
    procs, d = _ref_runs
    out = {}
    for arch, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, f"{arch}: {log[-4000:]}"
        out.update(np.load(d / f"{arch}.npz"))
    return out


def _count_groups(monkeypatch):
    """Records, per call of aggregators.aggregate_leaves, the leaves' dtypes."""
    calls = []
    real = aggregators.aggregate_leaves

    def wrapped(leaves, method, beta=0.1):
        calls.append(sorted({str(x.dtype) for x in leaves}))
        return real(leaves, method, beta)

    monkeypatch.setattr(aggregators, "aggregate_leaves", wrapped)
    return calls


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "mamba2_2_7b", "recurrentgemma_2b",
                                  "grok_1_314b"])
def test_cli_trains_each_family_in_bf16(monkeypatch, arch):
    """python -m repro_torch.launch.train --smoke --arch <family> on the CPU:
    the smoke configs are bf16 with float32 SSM / RG-LRU leaves; the worker
    buffer keeps every leaf's dtype, the gather median takes one
    aggregation call a step with one dtype group per leaf dtype, and the
    params keep their dtypes."""
    calls = _count_groups(monkeypatch)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = train.main(["--device", "cpu", "--config", arch, "--smoke", "--steps", "2",
                         "--device-steps", "1", "--workers", "4", "--seq-len", "16",
                         "--global-batch", "4", "--strategy", "gather", "--agg", "median",
                         "--attack", "alie", "--attack-alpha", "0.25", "--lr", "1e-3"])
    out = buf.getvalue()
    assert rc == 0 and "done: 2 steps" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    mixed = arch in ("mamba2_2_7b", "recurrentgemma_2b")
    assert calls == [["torch.bfloat16", "torch.float32"] if mixed else ["torch.bfloat16"]] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_window_ds1_matches_the_reference(ref, arch):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    mesh = mesh_lib.make_debug_mesh(4, 1, device="cpu")
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          remat=False)
    opt = get_optimizer("sgd", LR)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    state["params"] = convert.transformer_from_reference(cfg, _nested(ref, f"{arch}/init/"),
                                                         "cpu")
    state["opt_state"] = opt.init(state["params"])
    window = trainer.make_window_step(cfg, pcfg, mesh, opt, AttackConfig("alie", 0.25), 1)
    losses, norms = [], []
    for i in range(STEPS):
        before = {k: float(v) for k, v in state["metrics"].items()}
        batch = {k: torch.from_numpy(ref[f"{arch}/batch/{i}/{k}"])[None]
                 for k in ("tokens", "labels")}
        state = window(state, batch)
        met = trainer.window_metrics(before, state)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
    np.testing.assert_allclose(losses, ref[f"{arch}/loss"], rtol=1e-6)
    np.testing.assert_allclose(norms, ref[f"{arch}/grad_norm"], rtol=1e-6)
    want = _nested(ref, f"{arch}/params/")
    for path, t in tree_leaves_with_path(state["params"]):
        w = want
        for p in path.split("/"):
            w = w[int(p)] if isinstance(w, list) else w[p]
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-5, err_msg=path)
    init = _nested(ref, f"{arch}/init/")
    assert not np.array_equal(state["params"]["embed"].numpy(), init["embed"])
