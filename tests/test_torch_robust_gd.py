"""Algorithm 1 end to end: the port's robust_gd against the JAX reference
on the same numpy data and initial weights (CPU), plus the port's own
contracts — bit-identical resume, exact checkpoints, the device rule, the
kernel build's errors, and that neither a port module nor chip_smoke.py
imports JAX or the reference.

Trajectory tolerances: iterates differ by float32 reduction orders in
the gradients (the median / trimmed mean then select among values that
differ by the same few ulps), so 100 linreg iterations are held to
1e-5 absolute on ||w - w*|| (observed: 6e-8) and the CNN's 3 iterations
to 1e-4 of each leaf's scale.
"""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import robust_gd as jgd
from repro.core import theory as jtheory
from repro.core.attacks import AttackConfig as JAttackConfig
from repro.models import paper_models as JM
from repro_torch.checkpoint import checkpoint
from repro_torch.core import robust_gd as gd
from repro_torch.core import theory
from repro_torch.core.attacks import AttackConfig
from repro_torch.kernels import robust_agg
from repro_torch.kernels import select_codegen as G
from repro_torch.models import convert
from repro_torch.models import paper_models as M
from repro_torch.rounds import engine

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _linreg_problem(m=8, n=500, d=20, sigma=0.5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1.0, 1.0], np.float32), size=(m * n, d))
    w_star = (rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)
    y = (x @ w_star + sigma * rng.standard_normal(m * n)).astype(np.float32)
    return x.reshape(m, n, d), y.reshape(m, n), w_star


@pytest.mark.parametrize("method", ["mean", "median", "trimmed_mean"])
def test_linreg_trajectory_matches_reference_quickstart(method):
    # examples/quickstart.py: m=8, n=500, d=20, sign_flip alpha=0.25 scale 10
    x, y, w_star = _linreg_problem()
    kw = dict(method=method, beta=0.3, step_size=0.5, num_iters=100)
    jw, jerr = jgd.robust_gd(
        jgd.linreg_loss, jnp.zeros(20), (jnp.asarray(x), jnp.asarray(y)),
        jgd.RobustGDConfig(**kw), JAttackConfig("sign_flip", alpha=0.25, scale=10.0),
        lambda w: jnp.linalg.norm(w - w_star))
    ws = torch.from_numpy(w_star)
    tw, terr = gd.robust_gd(
        gd.linreg_loss, torch.zeros(20), (torch.from_numpy(x), torch.from_numpy(y)),
        gd.RobustGDConfig(**kw), AttackConfig("sign_flip", alpha=0.25, scale=10.0),
        lambda w: torch.linalg.vector_norm(w - ws))
    jerr, terr = np.asarray(jerr), terr.numpy()
    if method == "mean":  # diverges in both: the BROKEN line of the quickstart
        assert jerr[-1] > 0.2 and terr[-1] > 0.2
        np.testing.assert_allclose(terr[:10], jerr[:10], rtol=1e-4)
    else:
        assert terr[-1] < 0.2
        np.testing.assert_allclose(terr, jerr, atol=1e-5)


def test_run_linreg_experiment_robust_broken_split():
    cfg = lambda method: gd.RobustGDConfig(method=method, beta=0.3, step_size=0.5,
                                           num_iters=100)
    atk = AttackConfig("sign_flip", alpha=0.25, scale=10.0)
    errs = {m: float(gd.run_linreg_experiment(0, 20, 500, 8, 0.5, cfg(m), atk,
                                              device="cpu")[0])
            for m in ("mean", "median", "trimmed_mean")}
    assert errs["median"] < 0.2 and errs["trimmed_mean"] < 0.2 and not errs["mean"] < 0.2


@pytest.mark.parametrize("method", ["median", "trimmed_mean"])
def test_cnn_three_iterations_match_reference(method):
    m, n = 4, 8
    params_np = jax.tree.map(np.asarray, JM.init_cnn(jax.random.PRNGKey(3), width=4))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((m, n, 784)).astype(np.float32)
    y = rng.integers(0, 10, (m, n)).astype(np.int32)
    kw = dict(method=method, beta=0.25, step_size=0.05, num_iters=3)
    jw, _ = jgd.robust_gd(JM.cnn_loss, jax.tree.map(jnp.asarray, params_np),
                          {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                          jgd.RobustGDConfig(**kw), JAttackConfig("sign_flip", alpha=0.25,
                                                                  scale=20.0))
    tw, _ = gd.robust_gd(M.cnn_loss, convert.from_reference("cnn", params_np, device="cpu"),
                         {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()},
                         gd.RobustGDConfig(**kw), AttackConfig("sign_flip", alpha=0.25,
                                                               scale=20.0))
    got = convert.to_reference(tw)
    for k in params_np:
        want = np.asarray(jw[k])
        np.testing.assert_allclose(got[k], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_kill_and_resume_is_bit_identical(tmp_path):
    x, y, w_star = _linreg_problem(m=6, n=40, d=5, seed=1)
    data = (torch.from_numpy(x), torch.from_numpy(y))
    cfg = gd.RobustGDConfig(method="trimmed_mean", beta=0.2, step_size=0.3, num_iters=6)
    atk = AttackConfig("stale", alpha=0.3)  # adaptive: reads the prev-aggregate carry
    ws = torch.from_numpy(w_star)
    traj = lambda w: torch.linalg.vector_norm(w - ws)
    ck = str(tmp_path / "ck")
    w_full, m_full = gd.robust_gd(gd.linreg_loss, torch.zeros(5), data, cfg, atk, traj,
                                  ckpt_every=1, ckpt_dir=ck)
    assert engine.snapshot_rounds(ck) == [1, 2, 3, 4, 5]
    w_plain, _ = gd.robust_gd(gd.linreg_loss, torch.zeros(5), data, cfg, atk, traj)
    assert torch.equal(w_full, w_plain)
    for r in engine.snapshot_rounds(ck):
        w_r, m_r = gd.robust_gd(gd.linreg_loss, torch.zeros(5), data, cfg, atk, traj,
                                ckpt_every=1, ckpt_dir=ck, resume=r)
        assert torch.equal(w_r, w_full), r
        assert torch.equal(m_r, m_full[r:]), r
    w_t, _ = gd.robust_gd(gd.linreg_loss, torch.zeros(5), data, cfg, atk, traj,
                          ckpt_dir=ck, resume=True)
    assert torch.equal(w_t, w_full)
    # resume on an empty directory is a fresh start
    w_f, _ = gd.robust_gd(gd.linreg_loss, torch.zeros(5), data, cfg, atk, traj,
                          ckpt_every=2, ckpt_dir=str(tmp_path / "fresh"), resume=True)
    assert torch.equal(w_f, w_full)


def test_make_state_owns_its_leaves():
    w0 = torch.ones(3)
    state = engine.make_state(w0)
    state["w"].add_(1.0)
    assert torch.equal(w0, torch.ones(3))


def test_checkpoint_round_trip_keeps_dtypes(tmp_path):
    tree = {"w": {"a": torch.randn(3, 2), "b": torch.randn(4).to(torch.bfloat16)},
            "n": torch.tensor(7), "t": (torch.arange(3, dtype=torch.int32),), "e": ()}
    checkpoint.save(str(tmp_path), tree, step=5, extra={"host": {"k": 1}})
    like = {"w": {"a": torch.zeros(3, 2), "b": torch.zeros(4)}, "n": torch.tensor(0),
            "t": (torch.zeros(3),), "e": ()}
    back, step = checkpoint.restore(str(tmp_path), like)
    assert step == 5 and checkpoint.load_extra(str(tmp_path)) == {"host": {"k": 1}}
    assert back["w"]["b"].dtype == torch.bfloat16 and back["t"][0].dtype == torch.int32
    assert torch.equal(back["w"]["b"], tree["w"]["b"])
    assert torch.equal(back["w"]["a"], tree["w"]["a"]) and back["e"] == ()
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), dict(like, n=torch.zeros(2)))


def test_theory_values_equal_reference():
    for args in [(0.1, 100, 10, 20, 1.0, 1.0), (0.05, 300, 40, 784, 2.0, 0.5)]:
        assert theory.delta_median(*args) == jtheory.delta_median(*args)
    for fn, args in [("c_eps", (1 / 6,)), ("c_eps", (0.01,)), ("c_eps", (0.99,)),
                     ("median_condition", (0.1, 100, 10, 5, 1.0)),
                     ("delta_trimmed", (0.1, 100, 10, 20, 1.0)),
                     ("lower_bound", (0.1, 100, 10, 20)),
                     ("median_rate", (0.1, 100, 10)), ("one_round_rate", (0.2, 50, 8)),
                     ("effective_buffer", (0.2, 100, 30, 0.1)),
                     ("delta_median_async", (0.1, 100, 50, 20, 10, 1.0, 1.0)),
                     ("delta_trimmed_async", (0.2, 0.1, 100, 50, 20, 10, 1.0)),
                     ("async_optimal_rate", (0.1, 100, 50, 20)),
                     ("delta_median_compressed", (0.1, 100, 10, 20, 1.0, 1.0, 1.5)),
                     ("delta_trimmed_compressed", (0.1, 100, 10, 20, 1.0, 1.5)),
                     ("one_round_rate_compressed", (0.1, 100, 10, 2.0)),
                     ("compressed_breakdown", (0.5, 0.8)),
                     ("loglog_slope", ([1, 2, 4], [3.0, 1.4, 0.8])),
                     ("gd_iterations_strongly_convex", (2.0, 0.5, 0.01, 3.0))]:
        assert getattr(theory, fn)(*args) == getattr(jtheory, fn)(*args), fn


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(mod.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'repro' or k.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_chip_smoke_imports_neither_jax_nor_reference():
    # chip_smoke.py imports lazily inside its phases, so read every import
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    assert "repro_torch.core.robust_gd" in names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_refuse_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA: the default device is legitimately the card")
    cfg = gd.RobustGDConfig(num_iters=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gd.run_linreg_experiment(0, 4, 10, 3, 0.5, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cnn(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        robust_agg.prepare([("fused_median_trimmed", 10, 1, torch.float32)])


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(robust_agg, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        robust_agg._build_select([G.spec("fused_median_trimmed", 10, 1, torch.float32)])
    assert list(tmp_path.glob("select_*.cu"))  # the generated source was written
