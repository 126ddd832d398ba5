"""The robustness scenario matrix of the port (repro_torch.attacks.matrix)
against the reference (repro.attacks.matrix), on the CPU.

- The bounds (``cell_bound*``, ``feedback_sigma``) are pure math: equal to
  the reference's, value for value.
- ``corrupt_feedback``: feedback_flip bitwise the reference's;
  feedback_alie (a mean and a variance over the scores, summed in each
  package's own order) within 1e-6 absolute.
- The batched cells: one aggregation call over all cells (the median and
  trimmed mean flatten them to (m, C*d)) is bitwise the per-cell calls.
- Each grid at a reduced size (m = 16, n = 64, d = 16, 10 iterations) on
  the reference's data (``_make_data`` / ``_make_feedback_data`` replaced
  by the reference's arrays): the same cells in the same order, the same
  bounds, ``gated``/``feasible``/``ok`` flags, and ``err`` within 1e-4
  relative for every cell whose randomness the data fixes (observed: at
  most ~1e-6; gradients differ by a few ulps between the packages).  The
  cells that draw at run time — ``gauss``, the int8 dither, the
  count-sketch map — are held by their flags alone.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.attacks import engine as jengine
from repro.attacks import matrix as JM
from repro_torch.attacks import engine
from repro_torch.attacks import matrix as M
from repro_torch.core import aggregators

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")

CELL_KEYS = ("attack", "aggregator", "compression", "alpha", "m", "strength", "k", "k_frac",
             "dropout", "k_actual", "alpha_eff", "m_eff", "feasible", "gated", "ok")


# ------------------------------------------------------------- bounds


def test_constants_copied():
    assert (M.K_MEDIAN, M.K_TRIMMED, M.K_MEAN) == (JM.K_MEDIAN, JM.K_TRIMMED, JM.K_MEAN)
    assert M.DEFAULT_ATTACKS == JM.DEFAULT_ATTACKS
    for port, ref in ((M.MatrixConfig(), JM.MatrixConfig()), (M.SMOKE, JM.SMOKE),
                      (M.CompressedMatrixConfig(), JM.CompressedMatrixConfig()),
                      (M.COMPRESSED_SMOKE, JM.COMPRESSED_SMOKE),
                      (M.AsyncMatrixConfig(), JM.AsyncMatrixConfig()),
                      (M.ASYNC_SMOKE, JM.ASYNC_SMOKE),
                      (M.FeedbackMatrixConfig(), JM.FeedbackMatrixConfig()),
                      (M.FEEDBACK_SMOKE, JM.FEEDBACK_SMOKE)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


ALPHAS = (0.0, 0.05, 0.1, 0.15, 0.25, 0.3, 0.45, 0.5)


@pytest.mark.parametrize("agg", ["median", "trimmed_mean", "mean", "krum"])
def test_cell_bound_equals_reference(agg):
    for alpha in ALPHAS:
        for m in (8, 16, 32):
            for n, d, beta in ((64, 16, 0.3), (256, 32, 0.1)):
                assert M.cell_bound(agg, alpha, beta, n, m, d, 0.5) == \
                    JM.cell_bound(agg, alpha, beta, n, m, d, 0.5)


@pytest.mark.parametrize("comp", ["none", "int8", "topk", "count_sketch"])
def test_cell_bound_compressed_equals_reference(comp):
    for agg in ("median", "trimmed_mean", "mean"):
        for alpha in ALPHAS:
            for m in (16, 32):
                assert M.cell_bound_compressed(agg, comp, alpha, 0.3, 64, m, 16, 0.5) == \
                    JM.cell_bound_compressed(agg, comp, alpha, 0.3, 64, m, 16, 0.5)


def test_cell_bound_async_equals_reference():
    for agg in ("median", "trimmed_mean", "mean"):
        for alpha in ALPHAS[1:]:
            for m in (16, 32):
                for k in (1, 4, m // 2, m):
                    for dropout in (0.0, 0.25, 0.5):
                        assert M.cell_bound_async(agg, alpha, 0.3, 64, m, k, dropout, 16, 0.5) \
                            == JM.cell_bound_async(agg, alpha, 0.3, 64, m, k, dropout, 16, 0.5)


def test_feedback_bounds_equal_reference():
    for kw in (dict(), dict(score_base=0.6, score_spread=0.2, sigma=1.0), dict(n=64, d=16)):
        port, ref = M.FeedbackMatrixConfig(**kw), JM.FeedbackMatrixConfig(**kw)
        assert M.feedback_sigma(port) == JM.feedback_sigma(ref)
        for agg in ("median", "trimmed_mean", "mean"):
            for alpha in ALPHAS:
                for m in (16, 32):
                    assert M.cell_bound_feedback(agg, alpha, port, m) == \
                        JM.cell_bound_feedback(agg, alpha, ref, m)


def test_committed_grid_bounds_and_flags():
    """Every cell of the committed ROBUSTNESS.json (the reference's default
    configs) gets the same bound (1e-12 relative) and flags from the port's
    bound functions and async compositions."""
    with open(os.path.join(ROOT, "ROBUSTNESS.json")) as f:
        committed = json.load(f)
    fcfg = M.FeedbackMatrixConfig()
    acfg = M.AsyncMatrixConfig()
    checked = 0
    for grid in ("sync", "compressed", "async", "feedback"):
        for c in committed["cells"] if grid == "sync" else committed[grid]["cells"]:
            a, m, agg = c["alpha"], c["m"], c["aggregator"]
            if grid == "sync":
                bound = M.cell_bound(agg, a, 0.3, 256, m, 32, 0.5)
            elif grid == "compressed":
                bound = M.cell_bound_compressed(agg, c["compression"], a, 0.3, 256, m, 32, 0.5)
            elif grid == "async":
                rec, (_, _, h_buf) = next(
                    (r, comp) for r, comp in M.async_cells(acfg, m, agg)
                    if (r["alpha"], r["k"], r["dropout"]) == (a, c["k"], c["dropout"]))
                assert (rec["k_actual"], rec["alpha_eff"], rec["m_eff"]) == \
                    (c["k_actual"], c["alpha_eff"], c["m_eff"])
                feasible = h_buf >= 1
                assert feasible == c["feasible"]
                bound = (M.cell_bound_async(agg, a, 0.3, 256, m, c["k"], c["dropout"], 32, 0.5)
                         if feasible else None)
            else:
                bound = M.cell_bound_feedback(agg, a, fcfg, m)
            assert (bound is None) == (c["bound"] is None) and (bound is not None) == c["gated"]
            if bound is not None:
                assert abs(bound - c["bound"]) <= 1e-12 * abs(c["bound"])
            checked += 1
    assert checked == 276 + 40 + 64 + 42


# ----------------------------------------------------- corrupt_feedback


@pytest.mark.parametrize("name", ["feedback_flip", "feedback_alie"])
@pytest.mark.parametrize("strength", [None, 0.5, 1.0, 1.5, 3.0])
def test_corrupt_feedback_matches_reference(name, strength):
    rng = np.random.default_rng(7)
    for scores in (0.8 + 0.1 * np.tanh(rng.standard_normal(64)),
                   rng.uniform(-1, 1, 33), np.full(8, 0.3)):
        scores = scores.astype(np.float32)
        want = np.asarray(jengine.corrupt_feedback(name, scores, key=jax.random.PRNGKey(3),
                                                   strength=strength))
        got = engine.corrupt_feedback(name, torch.from_numpy(scores), strength=strength)
        assert got.dtype == torch.float32 and got.shape == scores.shape
        assert bool((got.abs() <= 1.0).all())
        if name == "feedback_flip":
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    x = torch.ones(4)
    assert engine.corrupt_feedback("sign_flip", x) is x  # identity off the feedback class


# --------------------------------------------------------- batched cells


@pytest.mark.parametrize("agg", ["median", "trimmed_mean", "mean", "krum"])
@pytest.mark.parametrize("m", [4, 13, 16, 32])
def test_batched_cells_bitwise_per_cell(agg, m):
    rng = np.random.default_rng(m)
    rows = torch.from_numpy(rng.standard_normal((9, m, 16)).astype(np.float32))
    rows[3, : m // 4] = 1e30  # a cell with huge Byzantine rows
    rows[5, 0, 2] = float("nan")
    got = M.aggregate_cells(agg, 0.3, rows)
    one = aggregators.get_aggregator(agg, 0.3)
    want = torch.stack([one(rows[c]) for c in range(rows.shape[0])])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


# ------------------------------------------- grids against the reference


@pytest.fixture
def reference_data(monkeypatch):
    def data(cfg, m, device):
        return tuple(torch.from_numpy(np.array(a)).to(device) for a in JM._make_data(cfg, m))

    def feedback_data(cfg, m, device):
        return tuple(torch.from_numpy(np.array(a)).to(device)
                     for a in JM._make_feedback_data(cfg, m))

    monkeypatch.setattr(M, "_make_data", data)
    monkeypatch.setattr(M, "_make_feedback_data", feedback_data)


REDUCED = dict(n=64, d=16, iters=10)
GRIDS = {
    "sync": (JM.evaluate, M.evaluate, "MatrixConfig", dict(ms=(16,))),
    "compressed": (JM.evaluate_compressed, M.evaluate_compressed,
                   "CompressedMatrixConfig", dict()),
    "async": (JM.evaluate_async, M.evaluate_async, "AsyncMatrixConfig", dict(ms=(16,))),
    "feedback": (JM.evaluate_feedback, M.evaluate_feedback, "FeedbackMatrixConfig",
                 dict(ms=(16,))),
}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_matches_reference_on_its_data(grid, reference_data):
    jfn, fn, cls, kw = GRIDS[grid]
    want = jfn(getattr(JM, cls)(**REDUCED, **kw))
    got = fn(getattr(M, cls)(**REDUCED, **kw), device="cpu")
    assert got["task"] == want["task"] and got["config"] == want["config"]
    assert len(got["cells"]) == len(want["cells"])
    held = 0
    for g, w in zip(got["cells"], want["cells"]):
        assert list(g) == list(w)  # the same keys in the same order
        assert {k: g.get(k) for k in CELL_KEYS} == {k: w.get(k) for k in CELL_KEYS}
        assert g["bound"] == w["bound"]
        drawn = g["attack"] == "gauss" or g.get("compression") in ("int8", "count_sketch")
        if w["err"] is not None and not drawn:
            assert math.isclose(g["err"], w["err"], rel_tol=1e-4), (g, w)
            held += 1
    assert held >= len(got["cells"]) // 2
    assert len(got["violations"]) == len(want["violations"]) == 0


# ---------------------------------------------------- the port's own grids


@pytest.mark.parametrize("grid", ["sync", "compressed", "async", "feedback"])
def test_smoke_grids_have_no_violation(grid):
    fn, cfg, want = {
        "sync": (M.evaluate, M.SMOKE, 3 * (15 * 3 + 1)),
        "compressed": (M.evaluate_compressed, M.COMPRESSED_SMOKE, 2 * 4 * (2 * 2 + 1)),
        "async": (M.evaluate_async, M.ASYNC_SMOKE, 2 * 2 * 2 * 2),
        "feedback": (M.evaluate_feedback, M.FEEDBACK_SMOKE, 3 * (2 * 3 + 1)),
    }[grid]
    out = fn(cfg, device="cpu")
    assert len(out["cells"]) == want and out["violations"] == []
    for c in out["cells"]:
        if c["gated"]:
            assert math.isfinite(c["err"]) and c["err"] <= c["bound"]
    if grid == "sync":
        assert out["num_traces"] == len(cfg.aggregators) * len(cfg.ms)
        # the non-robust mean breaks under a sign flip by more than one
        # worker in 16 (-10 g from 3 of 16 rows reverses the mean step):
        # recorded, not gated
        sf = [c for c in out["cells"] if c["aggregator"] == "mean"
              and c["attack"] == "sign_flip" and c["alpha"] >= 0.15]
        assert len(sf) == 2 and all(not c["gated"] and c["err"] > 1e3 for c in sf)
    if grid == "async":
        assert all(c["feasible"] for c in out["cells"] if c["k_frac"] == 1.0)


def test_non_coordinate_wise_aggregators_run_cell_by_cell():
    cfg = M.MatrixConfig(aggregators=("krum", "geometric_median"),
                         attacks=(("sign_flip", 10.0), ("mimic", 1.0)), alphas=(0.15,),
                         ms=(16,), n=32, d=8, iters=5)
    out = M.evaluate(cfg, device="cpu")
    assert len(out["cells"]) == 2 * 3 and not any(c["gated"] for c in out["cells"])
    assert all(math.isfinite(c["err"]) for c in out["cells"])


BREAKDOWN = M.MatrixConfig(aggregators=("median",), attacks=(("sign_flip", 10.0),),
                           alphas=(0.45,), ms=(16,), n=64, d=8, iters=40)


def test_gate_fires_on_breakdown(monkeypatch):
    """median at alpha=0.45 (< 1/2, still gated) with ceil(.45*16) = 8 = m/2
    Byzantine rows under a strong sign flip is broken: the gate fires and
    the CLI exits 1."""
    out = M.evaluate(BREAKDOWN, device="cpu")
    assert out["violations"]
    assert all(c["err"] > c["bound"] for c in out["violations"])
    monkeypatch.setattr(M, "SMOKE", BREAKDOWN)
    assert M.main(["--smoke", "--device", "cpu"]) == 1


def test_cli_smoke_json(tmp_path):
    path = tmp_path / "rob.json"
    out = subprocess.run([sys.executable, "-m", "repro_torch.attacks.matrix", "--smoke",
                          "--json", str(path), "--device", "cpu"],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "138 sync + 40 compressed + 16 async + 21 feedback cells" in out.stderr
    got = json.loads(path.read_text())
    with open(os.path.join(ROOT, "ROBUSTNESS.json")) as f:
        committed = json.load(f)
    assert sorted(got) == sorted(committed)
    for grid in ("compressed", "async", "feedback"):
        assert sorted(got[grid]) == sorted(committed[grid])
        assert list(got[grid]["cells"][0]) == list(committed[grid]["cells"][0])
    assert list(got["cells"][0]) == list(committed["cells"][0])


def test_cli_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA: the default device is legitimately the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.main(["--smoke"])
