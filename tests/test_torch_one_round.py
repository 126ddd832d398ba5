"""Algorithm 2 (``rounds.one_round``) on the port against the JAX
reference, on the same numpy data (CPU).

Tolerances: a worker's local solution differs from the reference's by
float32 summation order in the normal equations or the GD steps (a few
ulps of O(1) values); the median and trimmed mean then select among
values that differ by the same, so the aggregate is held to 1e-5
absolute for the quadratic solver and 1e-4 for 100 logistic GD steps.
The streaming path is held to one bin width of the exact one-round
estimator, as the reference's own test holds it (5e-3 at 512 bins).
Theorem 7's rate bound and the robust/broken splits are the reference's
gates (tests/test_robust_gd.py, tests/test_rounds.py).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as jtheory
from repro.core.attacks import AttackConfig as JAttackConfig
from repro.models import paper_models as JM
from repro.rounds import (OneRoundConfig as JOneRoundConfig,
                          make_gd_local_solver as j_gd_solver, one_round as j_one_round,
                          one_round_streaming as j_one_round_streaming,
                          quadratic_local_solver as j_quadratic)
from repro_torch.core.attacks import AttackConfig
from repro_torch.models import paper_models as M
from repro_torch.rounds import (OneRoundConfig, make_gd_local_solver, one_round,
                                one_round_streaming, quadratic_local_solver)

torch.set_num_threads(2)

K_ONE_ROUND = 2.5  # the reference test's constant


def _linreg(n, m, d=16, sigma=0.5, seed=0, w_star=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n, d)).astype(np.float32)
    if w_star is None:
        w_star = (rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)
    y = (x @ w_star + sigma * rng.standard_normal((m, n))).astype(np.float32)
    return x, y, w_star


def _both(x, y):
    return (torch.from_numpy(x), torch.from_numpy(y)), (jnp.asarray(x), jnp.asarray(y))


def _err(w, w_star):
    return float(np.linalg.norm(np.asarray(w) - w_star))


# ------------------------------------------ tests/test_robust_gd.py::TestOneRound


def test_quadratic_clean_matches_reference():
    x, y, w_star = _linreg(100, 20, d=10, sigma=0.3, w_star=np.ones(10, np.float32))
    t, j = _both(x, y)
    got = one_round(quadratic_local_solver, t, OneRoundConfig("median"))
    want = j_one_round(j_quadratic, j, JOneRoundConfig("median"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert _err(got, w_star) < 0.1


@pytest.mark.parametrize("method", ["median", "trimmed_mean", "mean"])
def test_quadratic_byzantine_matches_reference(method):
    x, y, w_star = _linreg(100, 20, d=10, sigma=0.3, w_star=np.ones(10, np.float32))
    t, j = _both(x, y)
    got = one_round(quadratic_local_solver, t, OneRoundConfig(method, beta=0.2),
                    AttackConfig("large_value", alpha=0.2, scale=100.0))
    want = j_one_round(j_quadratic, j, JOneRoundConfig(method, beta=0.2),
                       JAttackConfig("large_value", alpha=0.2, scale=100.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    if method == "mean":
        assert _err(got, w_star) > 1.0
    else:
        assert _err(got, w_star) < 0.2


def test_gd_solver_logistic_matches_reference():
    """The paper's Table 4 setting at a small size: one-round median of 100
    local logistic GD steps."""
    m, n, d, c = 10, 200, 20, 4
    rng = np.random.default_rng(0)
    mus = rng.standard_normal((c, d)).astype(np.float32)
    mus *= 3.0 / np.linalg.norm(mus, axis=1, keepdims=True)
    labels = rng.integers(0, c, m * n)
    feats = (mus[labels] + rng.standard_normal((m * n, d))).astype(np.float32)
    shards = {"x": feats.reshape(m, n, d), "y": labels.reshape(m, n).astype(np.int32)}
    atk, jatk = (AttackConfig("large_value", alpha=0.2, scale=50.0),
                 JAttackConfig("large_value", alpha=0.2, scale=50.0))
    w0 = M.init_logreg(d=d, num_classes=c, device="cpu")
    jw0 = {k: jnp.asarray(v.numpy()) for k, v in w0.items()}
    solver = make_gd_local_solver(M.logreg_loss, w0, steps=100, lr=0.5)
    jsolver = j_gd_solver(lambda w, b: JM.logreg_loss(w, {"x": b["x"], "y": b["y"]}), jw0,
                          steps=100, lr=0.5)
    tdata = {"x": torch.from_numpy(shards["x"]), "y": torch.from_numpy(shards["y"]).long()}
    jdata = {k: jnp.asarray(v) for k, v in shards.items()}
    got = one_round(solver, tdata, OneRoundConfig("median"), atk)
    want = j_one_round(jsolver, jdata, JOneRoundConfig("median"), jatk)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4)
    clean = one_round(solver, tdata, OneRoundConfig("mean"))
    delta = torch.linalg.vector_norm(got["w"] - clean["w"]) / torch.linalg.vector_norm(clean["w"])
    assert float(delta) < 0.5


# -------------------------------------- tests/test_rounds.py::TestOneRoundTheorem7


def test_rate_bound_over_grid():
    d, sigma = 16, 0.5
    for alpha in (0.0, 0.1, 0.2):
        for m in (8, 32):
            for n in (32, 128):
                x, y, w_star = _linreg(n, m, d, sigma, seed=m + n)
                atk = AttackConfig("sign_flip", alpha=alpha, scale=10.0) if alpha else None
                w = one_round(quadratic_local_solver, _both(x, y)[0], OneRoundConfig("median"),
                              attack=atk)
                bound = K_ONE_ROUND * sigma * np.sqrt(d) * jtheory.one_round_rate(alpha, n, m)
                assert _err(w, w_star) <= bound, (alpha, n, m)


def test_error_improves_with_n():
    errs = {}
    for n in (32, 512):
        x, y, w_star = _linreg(n, 16, seed=1)
        w = one_round(quadratic_local_solver, _both(x, y)[0], OneRoundConfig("median"))
        errs[n] = _err(w, w_star)
    assert errs[512] < 0.6 * errs[32], errs


def test_median_survives_where_mean_breaks():
    x, y, w_star = _linreg(64, 16, seed=2)
    t = _both(x, y)[0]
    atk = AttackConfig("sign_flip", alpha=0.2, scale=50.0)
    assert _err(one_round(quadratic_local_solver, t, OneRoundConfig("median"), atk),
                w_star) < 0.5
    assert _err(one_round(quadratic_local_solver, t, OneRoundConfig("mean"), atk), w_star) > 5.0


@pytest.mark.parametrize("method", ["median", "trimmed_mean", "approx_median"])
def test_streaming_matches_exact_and_reference(method):
    x, y, _ = _linreg(32, 64, seed=3)
    t, j = _both(x, y)
    exact = one_round(quadratic_local_solver, t, OneRoundConfig(method.replace("approx_", "")))
    got = one_round_streaming(quadratic_local_solver, t, OneRoundConfig(method),
                              chunk_workers=16, nbins=512)
    want = j_one_round_streaming(j_quadratic, j, JOneRoundConfig(method),
                                 chunk_workers=16, nbins=512)
    assert got.shape == (16,)
    assert float((got - exact).abs().max()) < 5e-3  # one bin width, as the reference
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-3)


def test_streaming_under_attack():
    x, y, w_star = _linreg(64, 64, seed=4)
    t, j = _both(x, y)
    atk = AttackConfig("large_value", alpha=0.25, scale=50.0)
    kw = dict(chunk_workers=16, nbins=512)
    w_med = one_round_streaming(quadratic_local_solver, t, OneRoundConfig("median"), atk, **kw)
    w_mean = one_round_streaming(quadratic_local_solver, t, OneRoundConfig("mean"), atk, **kw)
    assert _err(w_med, w_star) < 1.0 and _err(w_mean, w_star) > 2.0
    want = j_one_round_streaming(j_quadratic, j, JOneRoundConfig("median"),
                                 JAttackConfig("large_value", alpha=0.25, scale=50.0), **kw)
    np.testing.assert_allclose(w_med.numpy(), np.asarray(want), rtol=0, atol=5e-3)


def test_streaming_unravels_a_tree_solution():
    x, y, _ = _linreg(32, 40, d=6, seed=5)
    t = _both(x, y)[0]
    solver = lambda b: {"w": quadratic_local_solver(b).reshape(2, 3),  # noqa: E731
                        "s": quadratic_local_solver(b)[:1]}
    exact = one_round(solver, t, OneRoundConfig("median"))
    got = one_round_streaming(solver, t, OneRoundConfig("median"), chunk_workers=7, nbins=512)
    assert got["w"].shape == (2, 3) and got["s"].shape == (1,)
    for k in got:
        assert float((got[k] - exact[k]).abs().max()) < 5e-3


def test_adaptive_and_bare_attacks_refused():
    x, y, _ = _linreg(16, 4, d=4)
    t = _both(x, y)[0]
    for fn in (one_round, one_round_streaming):
        with pytest.raises(ValueError, match="adaptive"):
            fn(quadratic_local_solver, t, OneRoundConfig("median"),
               attack=AttackConfig("stale", alpha=0.25))
        with pytest.raises(ValueError, match="Byzantine fraction"):
            fn(quadratic_local_solver, t, OneRoundConfig("median"), attack="alie")


def test_int8_compressed_one_round_stays_robust():
    x, y, w_star = _linreg(128, 16, seed=6)
    t = _both(x, y)[0]
    atk = AttackConfig("sign_flip", alpha=0.2, scale=50.0)
    plain = one_round(quadratic_local_solver, t, OneRoundConfig("median"), atk)
    w = one_round(quadratic_local_solver, t, OneRoundConfig("median"), atk, compression="int8")
    assert not torch.equal(w, plain) and _err(w, w_star) < 0.5


def test_count_sketch_one_round_is_the_decoded_median_of_sketches():
    """One round has one public sketch map, so (the decode being linear and
    the median odd) the one-round median of decoded rows is the decode of
    the coordinate median of the workers' sketches."""
    x, y, _ = _linreg(64, 15, seed=7)
    t = _both(x, y)[0]
    got = one_round(quadratic_local_solver, t, OneRoundConfig("median"),
                    compression="count_sketch")
    rows = torch.func.vmap(quadratic_local_solver)(t)
    gen = importlib.import_module("repro_torch.rng").generator(11)  # one_round's codec seed
    from repro_torch.rounds import compression as C

    h, s = C.sketch_draw(16, gen)
    sketches = C._sketch_encode(rows, 0.5, draw=(h, s))["sketch"]
    want = s * sketches.median(dim=0).values[h]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_core_one_round_shim_exports():
    legacy = importlib.import_module("repro_torch.core.one_round")
    mod = importlib.import_module("repro_torch.rounds.one_round")
    for name in legacy.__all__:
        assert getattr(legacy, name) is getattr(mod, name)
    assert legacy.one_round is one_round
    assert legacy.OneRoundConfig is OneRoundConfig
