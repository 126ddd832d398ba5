"""The port's three examples (``examples/torch_*.py``) on the CPU, against
the reference's examples where they run here.

- The LM example's ``main`` at ``make_debug_mesh(4, 2)`` against the
  reference's same loop (its ``steps.make_train_step`` under the bucketed
  median, AdamW 3e-4, ``label_flip`` at alpha 0.25) at
  ``make_debug_mesh(4, 1)``: the
  reference's model-2 path raises ``ShardingTypeError`` in this jax, and
  its params go replicated, as tests/test_torch_tp.py runs its step.  The
  model is cut to 2 layers, d 64, 4 heads, kv 2, vocab 256, in float32,
  over 3 steps of seq 16 and batch 8; the port's example starts from the
  reference's params (``models.convert``) on the reference's batches (its
  ``init_params`` and ``make_lm_batch`` replaced for the test).
- Each example's ``main`` end to end with ``--device cpu``: the LM
  example at that small width (its checkpoint restores bitwise), the
  one-round example at its defaults, the quickstart at its defaults.
- The one-round path fed the reference's data: the reference example's
  own ``mnist_analog`` draws and random labels, as numpy, through the
  port's ``one_round`` / ``one_round_streaming``.

The reference runs in two subprocesses (4 forced CPU devices), started
when the module starts, while the in-process tests run.

Tolerances, stated where used:
- the LM loop: losses and grad norms within 1e-6 relative, params within
  1e-5 absolute (tests/test_torch_trainer.py's, f32);
- the one-round weights: 150 logistic GD steps at lr 0.3 are a
  gradient-dependent trajectory in float32 summation orders that differ;
  mean, median and streaming median within ``ONE_ROUND_ATOL`` absolute,
  test accuracies within one test point in 2,000 (0.0005) of the
  reference's;
- the streaming median within one bin width (max - min) / 512 of the
  exact median of the same rows, as the reference's own test holds it.

At the example's defaults the median does NOT beat the mean in either
package (the reference prints 83.1 % mean, 81.8 % median on the
CPU): one random-label worker in ten shrinks the mean's weights
without moving its argmax much, and the median of ten solutions is the
noisier estimator.  The tests hold the port to the reference's figures
instead.
"""
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_extra, restore
from repro_torch.launch.mesh import mesh_shape_dict
from repro_torch.models import convert
from repro_torch.tree import tree_leaves_with_path

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(name="demo-small", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=172,
             vocab=256, dtype="float32")
LM_ARGS = ["--steps", "3", "--seq-len", "16", "--global-batch", "8", "--device", "cpu"]
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
ONE_ROUND_ATOL = 1e-4
ACC_TOL = 0.0005

# The reference's two runs, each in a process of its own (argv[4] names it:
# "lm" or "or"), both started when the module starts.  Its init, draws and
# local solver run under jit: the same functions, compiled once instead of
# dispatched op by op (the port is fed whatever they produce).  The m local
# solutions are computed once; ``one_round`` and ``one_round_streaming`` then
# run on them with the identity as the local solver (each vmaps its solver
# over the workers and aggregates what comes out, so they aggregate the same
# rows).
REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ParallelConfig
from repro.configs.base import ModelConfig
from repro.core.attacks import AttackConfig
from repro.core.robust_gd import make_worker_shards
from repro.data.pipeline import DataConfig, host_to_mesh, make_lm_batch
from repro.data.synthetic import mnist_analog
from repro.launch import steps
from repro.launch.mesh import make_debug_mesh
from repro.models import transformer as T
from repro.models.paper_models import init_logreg, logreg_accuracy, logreg_loss
from repro.optim.optimizers import get_optimizer
from repro.rounds import OneRoundConfig, make_gd_local_solver, one_round, one_round_streaming

out = {}


def dump(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)


def lm(spec):
    # examples/train_lm_robust.py's loop at make_debug_mesh(4, 1), replicated
    # params: with this jax the embed's model-axis sharding makes the gather
    # raise ShardingTypeError even at model size 1
    steps.param_shardings = lambda cfg, mesh: jax.tree.map(
        lambda _: NamedSharding(mesh, P()), steps.T.param_shapes(cfg),
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    cfg = ModelConfig(family="dense", rope_theta=10000.0, **spec["cfg"])
    mesh = make_debug_mesh(4, 1)
    attack = AttackConfig("label_flip", 0.25)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="bucketed", remat=False,
                          attn_chunk=0)
    opt = get_optimizer("adamw", 3e-4)
    dcfg = DataConfig(kind="lm", vocab=cfg.vocab, seq_len=spec["seq"],
                      global_batch=spec["batch"], num_workers=4)
    with jax.set_mesh(mesh):
        params = jax.jit(lambda k: T.init_params(cfg, k))(jax.random.PRNGKey(0))
        pshard = steps.param_shardings(cfg, mesh)
        params = jax.tree.map(lambda x, s: jax.device_put(x, s), params, pshard)
        dump("lm/init/", params)
        opt_state = opt.init(params)
        train_step = steps.make_train_step(cfg, pcfg, mesh, opt, attack)
        losses, norms = [], []
        for step in range(spec["steps"]):
            host = make_lm_batch(dcfg, step, attack)
            out[f"lm/batch/{step}/tokens"] = np.asarray(host["tokens"])
            out[f"lm/batch/{step}/labels"] = np.asarray(host["labels"])
            batch = host_to_mesh(host, mesh, ("data",))
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    jnp.int32(step))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    out["lm/loss"] = np.array(losses)
    out["lm/grad_norm"] = np.array(norms)
    dump("lm/params/", params)


def one_round_example(examples):
    # examples/one_round_federated.py: its data, labels and three aggregates
    sys.path.insert(0, examples)
    import one_round_federated as E

    M, N, D, C = E.M, E.N, E.D, E.C
    draw = jax.jit(mnist_analog, static_argnums=(1,), static_argnames=("d", "num_classes"))
    train = draw(E.KEY, M * N, d=D, num_classes=C)
    test = draw(jax.random.PRNGKey(99), 2000, d=D, num_classes=C)
    xs, ys = make_worker_shards((train["x"], train["y"]), M)
    q = AttackConfig("random_label", alpha=0.1, num_classes=C).num_byzantine(M)
    ys_bad = ys.at[:q].set(jax.random.randint(jax.random.PRNGKey(1), ys[:q].shape, 0, C))
    shards = {"x": xs, "y": ys_bad}
    w0 = init_logreg(E.KEY, d=D, num_classes=C)
    solver = make_gd_local_solver(lambda w, b: logreg_loss(w, {"x": b["x"], "y": b["y"]}),
                                  w0, steps=150, lr=0.3)
    out.update({"or/x": np.asarray(xs), "or/y": np.asarray(ys_bad),
                "or/test_x": np.asarray(test["x"]), "or/test_y": np.asarray(test["y"])})
    rows = jax.jit(jax.vmap(solver))(shards)
    ws = {m: one_round(lambda w: w, rows, OneRoundConfig(m)) for m in ("mean", "median")}
    ws["median_stream"] = one_round_streaming(lambda w: w, rows, OneRoundConfig("median"),
                                              chunk_workers=4, nbins=512)
    for name, w in ws.items():
        dump(f"or/{name}/", w)
        out[f"or/{name}/acc"] = np.asarray(logreg_accuracy(w, test))
    for k, r in rows.items():  # the sketch's bin widths
        r = np.asarray(r).reshape(M, -1)
        out[f"or/width/{k}"] = (r.max(0) - r.min(0)) / 512


if sys.argv[4] == "lm":
    lm(json.loads(sys.argv[1]))
else:
    one_round_example(sys.argv[3])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _small_lm():
    """The LM example's module with its ``CFG`` cut to SMALL."""
    lm = _load("torch_train_lm_robust")
    lm.CFG = dataclasses.replace(lm.CFG, **SMALL)
    return lm


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.dtype.itemsize == 2 else torch.int32) \
        if t.is_floating_point() else t


@pytest.fixture(scope="module", autouse=True)
def _ref_runs(tmp_path_factory):
    """The reference's two runs (REF_SCRIPT), started when the module starts
    so that the in-process tests run while they do."""
    d = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    spec = json.dumps({"cfg": SMALL, "seq": 16, "batch": 8, "steps": 3})
    procs = [(subprocess.Popen([sys.executable, "-c", REF_SCRIPT, spec, str(d / f"{part}.npz"),
                                os.path.join(ROOT, "examples"), part],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True), d / f"{part}.npz") for part in ("lm", "or")]
    yield procs
    for proc, _ in procs:
        proc.kill()


@pytest.fixture(scope="module")
def ref(_ref_runs):
    out = {}
    for proc, path in _ref_runs:
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, log[-4000:]
        out.update(np.load(path))
    return out


@pytest.fixture(scope="module")
def one_round_main():
    """The one-round example's ``main`` at its defaults on the CPU."""
    return _quiet(_load("torch_one_round_federated").main, ["--device", "cpu"])


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


# ---------------------------------------------------------------------------
# in process (the reference runs meanwhile)
# ---------------------------------------------------------------------------


def test_lm_main_runs_and_its_checkpoint_restores_bitwise(tmp_path):
    """``main`` at the small width on the CPU: finite losses and norms a
    step, the mesh's shape, and the saved params restored bit for bit with
    the reference's ``extra`` (arch, agg)."""
    lm = _small_lm()
    ck = str(tmp_path / "ck")
    out, text = _quiet(lm.main, LM_ARGS + ["--ckpt", ck])
    assert text.splitlines()[0].startswith("model: ") and "mesh 4 workers x 2 TP" in text
    assert f"done; checkpoint at {ck}" in text
    assert len(out["losses"]) == len(out["grad_norms"]) == 3
    assert np.isfinite(out["losses"]).all() and np.isfinite(out["grad_norms"]).all()
    assert mesh_shape_dict(out["mesh"]) == {"data": 4, "model": 2}
    like = {"params": out["params"]}
    got, step = restore(ck, like)
    assert step == 3 and load_extra(ck) == {"arch": "demo-small", "agg": "median"}
    for (path, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(like)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), path


def test_lm_example_width_is_the_reference_s():
    """demo-100m as the reference builds it: 99,496,704 parameters, and its
    kv heads divide the model axis (every attention leaf split at model 2)."""
    from repro.models import transformer as RT
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T

    lm = _load("torch_train_lm_robust")
    spec = importlib.util.spec_from_file_location(
        "ref_train_lm_robust", os.path.join(ROOT, "examples", "train_lm_robust.py"))
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    assert dataclasses.asdict(lm.CFG) == dataclasses.asdict(ref_mod.CFG)
    assert T.count_params(lm.CFG) == RT.count_params(ref_mod.CFG) == 99_496_704
    assert sharding.tp_modes(lm.CFG, 2).attn == "heads"


def test_quickstart_main_at_its_defaults():
    """``main`` on the CPU: the median and trimmed mean ROBUST, the mean
    BROKEN, as examples/quickstart.py prints them."""
    out, text = _quiet(_load("torch_quickstart").main, ["--device", "cpu"])
    err = out["err"]
    assert err["median"] < 0.2 and err["trimmed_mean"] < 0.2 and not err["mean"] < 0.2, err
    assert "[ROBUST]" in text and "[BROKEN]" in text
    assert 0 < out["rate"] < 1


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_one_round_federated",
                                  "torch_train_lm_robust"])
def test_examples_run_on_the_card_by_default(name):
    """Without ``--device`` each example asks for the card; where there is
    none it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _quiet(_load(name).main, [])


def test_one_round_main_at_its_defaults(one_round_main):
    """``main`` on the CPU: the three accuracies printed and returned, each
    a working classifier, the median within three points of the mean (the
    reference's own gap is 1.3), and the streaming median within one bin
    width of the exact one on the same rows."""
    out, text = one_round_main
    assert text.splitlines()[0] == ("m=10 workers, 1 Byzantine (random labels), "
                                    "one communication round")
    acc = out["acc"]
    for name, label in (("mean", "mean    aggregation"), ("median", "median  aggregation"),
                        ("median_stream", "median (streaming sketch)")):
        assert f"{label}: test accuracy {acc[name] * 100:5.1f}%" in text
        assert acc[name] > 0.75, (name, acc)
    assert abs(acc["median"] - acc["mean"]) < 0.03, acc
    rows = torch.func.vmap(out["solver"])(out["shards"])
    for k in ("w", "b"):
        r = rows[k].reshape(rows[k].shape[0], -1)
        width = (r.max(0).values - r.min(0).values) / 512
        dev = (out["w"]["median_stream"][k] - out["w"]["median"][k]).reshape(-1).abs()
        assert bool((dev <= width).all()), (k, float((dev - width).max()))


# ---------------------------------------------------------------------------
# against the reference's run
# ---------------------------------------------------------------------------


def test_lm_loop_at_model_two_matches_the_reference(ref, tmp_path, monkeypatch):
    """3 AdamW steps under label_flip through the bucketed median: the
    port's example at (4, 2), its params and batches replaced by the
    reference's, against the reference's loop at (4, 1)."""
    lm = _small_lm()
    params = convert.transformer_from_reference(lm.CFG, _nested(ref, "lm/init/"), "cpu")
    monkeypatch.setattr(lm.T, "init_params", lambda cfg, seed=0, device="cuda": params)
    monkeypatch.setattr(lm, "make_lm_batch", lambda dcfg, step, attack=None, device="cuda": {
        k: torch.from_numpy(ref[f"lm/batch/{step}/{k}"]) for k in ("tokens", "labels")})
    out, text = _quiet(lm.main, LM_ARGS + ["--ckpt", str(tmp_path / "ck")])
    np.testing.assert_allclose(out["losses"], ref["lm/loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["grad_norms"], ref["lm/grad_norm"], rtol=LOSS_RTOL)
    want = _nested(ref, "lm/params/")
    for path, t in tree_leaves_with_path(out["params"]):
        w = want
        for p in path.split("/"):
            w = w[p]
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=PARAM_ATOL, err_msg=path)
    assert not np.array_equal(out["params"]["embed"].numpy(), ref["lm/init/embed"])
    printed = [ln.split()[:4] for ln in text.splitlines() if ln.startswith("step")]
    assert printed == [["step", "0", "loss", f"{ref['lm/loss'][0]:.4f}"],
                       ["step", "2", "loss", f"{ref['lm/loss'][2]:.4f}"]]


def test_one_round_on_the_reference_s_data(ref):
    """The reference example's draws and random labels through the port's
    ``run``: the mean and median within ONE_ROUND_ATOL, the streaming
    median within ONE_ROUND_ATOL plus one bin width (a row that moves by
    the trajectory's drift across a bin edge moves the sketch's median by
    a bin), the accuracies within ACC_TOL of the reference's."""
    ex = _load("torch_one_round_federated")
    shards = {"x": torch.from_numpy(ref["or/x"]), "y": torch.from_numpy(ref["or/y"]).long()}
    test = {"x": torch.from_numpy(ref["or/test_x"]),
            "y": torch.from_numpy(ref["or/test_y"]).long()}
    out, _ = _quiet(ex.run, shards, test, ex.make_solver("cpu"))
    for name in ("mean", "median", "median_stream"):
        for k in ("w", "b"):
            want = ref[f"or/{name}/{k}"]
            atol = ONE_ROUND_ATOL + (ref[f"or/width/{k}"].reshape(want.shape)
                                     if name == "median_stream" else 0.0)
            dev = np.abs(out["w"][name][k].numpy() - want)
            assert (dev <= atol).all(), (name, k, float((dev - atol).max()))
        assert abs(out["acc"][name] - float(ref[f"or/{name}/acc"])) <= ACC_TOL, name
