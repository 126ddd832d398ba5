"""Parity of the port's aggregator registry and histogram-sketch math with
the JAX reference, on the same numpy inputs (CPU).

Tolerances: median / trimmed mean through the network are bitwise (the
reference runs its eager selection network); sums whose order differs
between XLA and torch (mean, krum's Gram matrix, Weiszfeld, sketch bin
sums, the top-k band) are held to 1e-5 relative plus 1e-5 of the row
scale; the sketch's bin counts are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JA
from repro.kernels import histogram_agg as JH
from repro_torch.core import aggregators as A
from repro_torch.kernels import histogram_agg as H

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(m, shape=(6, 7), seed=0):
    return np.random.default_rng(seed).standard_normal((m,) + shape).astype(np.float32)


def _run(name, x, beta=0.2):
    got = A.get_aggregator(name, beta)(torch.from_numpy(x))
    want = JA.get_aggregator(name, beta)(jnp.asarray(x))
    return got.numpy(), np.asarray(want)


def test_registry_names_flags_and_breakdowns_match():
    assert A.registered_aggregators() == JA.registered_aggregators()
    for name in JA.registered_aggregators():
        a, j = A.get_aggregator_spec(name), JA.get_aggregator_spec(name)
        assert (a.exact, a.breakdown, a.summary) == (j.exact, j.breakdown, j.summary)
    with pytest.raises(ValueError):
        A.get_aggregator("nope")


@pytest.mark.parametrize("m", [5, 10, 40])
@pytest.mark.parametrize("name", ["median", "trimmed_mean"])
def test_exact_order_statistics_bitwise(name, m):
    got, want = _run(name, _x(m, seed=m))
    assert got.shape == want.shape == (6, 7)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", ["mean", "krum", "multi_krum", "geometric_median"])
def test_other_aggregators_match(name):
    got, want = _run(name, _x(11, seed=3))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["approx_median", "approx_trimmed_mean"])
def test_approx_aggregators_match(name):
    got, want = _run(name, _x(20, seed=4))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("m", [65, 96, 130])
def test_large_m_paths_match(m):
    x = _x(m, shape=(50,), seed=m)
    for name, beta in (("median", 0.1), ("trimmed_mean", 0.1), ("trimmed_mean", 0.3)):
        got, want = _run(name, x, beta)
        np.testing.assert_allclose(got, want, **TOL)


def test_topk_band_sum_survives_byzantine_scale_rows():
    # regression case: ±1e30 trimmed rows must not cancel the honest band
    rng = np.random.default_rng(5)
    m, b = 128, 8
    x = rng.standard_normal((m, 40)).astype(np.float32)
    x[:b // 2] = 1e30
    x[b // 2:b] = -1e30
    x[b:b + 3, :5] = x[b + 3, :5]  # ties at a threshold
    got = A._trimmed_mean_topk(torch.from_numpy(x), b).numpy()
    want = np.asarray(JA._trimmed_mean_topk(jnp.asarray(x), b))
    np.testing.assert_allclose(got, want, **TOL)
    exact = np.sort(x, axis=0)[b:m - b].mean(axis=0)
    np.testing.assert_allclose(got, exact, **TOL)


def test_tree_aggregate_over_dicts():
    tree = {"w": _x(7, (3, 4), 1), "b": _x(7, (4,), 2)}
    got = A.tree_aggregate({k: torch.from_numpy(v) for k, v in tree.items()}, "median")
    want = JA.tree_aggregate({k: jnp.asarray(v) for k, v in tree.items()}, "median")
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


def test_trimmed_mean_validates_beta():
    with pytest.raises(ValueError):
        A.coordinate_trimmed_mean(torch.zeros(4, 3), 0.5)
    assert torch.equal(A.coordinate_trimmed_mean(torch.ones(4, 3), 0.1), torch.ones(3))


# ------------------------------------------------------ histogram sketch


def test_sketch_counts_exact_and_estimators_match():
    x = _x(33, shape=(64,), seed=9)
    x[:, 0] = 1.5  # a zero-width coordinate
    counts, sums, lo, width = H.sketch_array(torch.from_numpy(x), 16)
    jc, js, jlo, jw = JH.sketch_array(jnp.asarray(x), 16)
    assert np.array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), **TOL)
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    assert np.array_equal(width.numpy(), np.asarray(jw))
    for m, fn, jfn in ((33, H.median_from_hist, JH.median_from_hist),
                       (32, H.median_from_hist, JH.median_from_hist)):
        np.testing.assert_allclose(fn(counts, lo, width, m).numpy(),
                                   np.asarray(jfn(jc, jlo, jw, m)), **TOL)
    np.testing.assert_allclose(
        H.quantile_from_hist(counts, lo, width, 33, 0.25).numpy(),
        np.asarray(JH.quantile_from_hist(jc, jlo, jw, 33, 0.25)), **TOL)
    np.testing.assert_allclose(
        H.trimmed_mean_from_hist(counts, sums, lo, width, 33, 0.2).numpy(),
        np.asarray(JH.trimmed_mean_from_hist(jc, js, jlo, jw, 33, 0.2)), **TOL)
    c2, s2 = H.hist_update(counts, None, torch.from_numpy(x), lo, width)
    assert s2 is None and torch.equal(c2, 2 * counts)


# --------------------------------------- float16, float64 and empty leaves
#
# The route of the exact median / trimmed mean is decided by shape, dtype
# and device before any kernel runs (ops.route).  float16 takes the kernels
# on the card and the network on the CPU; float64 takes the network on both
# (the reference aggregates float64 only through its jnp network); a leaf
# with no coordinates takes no launch at all.  Parity is bitwise: the
# reference runs the same selection network on the same inputs.


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16,
                                   torch.float64])
@pytest.mark.parametrize("m,n", [(1, 5), (10, 5), (64, 5), (65, 5), (10, 0), (70, 0)])
def test_auto_route_by_dtype_device_and_width(device, dtype, m, n):
    from repro_torch.kernels import ops

    if n == 0:
        want = "empty"
    elif m > 64:
        want = "sort"
    elif device == "cuda" and dtype != torch.float64:
        want = "cuda"
    else:
        want = "network" if m >= 2 else "sort"
    assert ops.route(m, n, dtype, device) == want
    if device == "cpu":
        assert ops.auto_backend(torch.zeros((m, n, 1), dtype=dtype)) == want


def _as_jax(x, dtype):
    return jnp.asarray(x, dtype={torch.float16: jnp.float16, torch.float64: jnp.float64}[dtype])


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("m", [2, 3, 10, 31, 64])
@pytest.mark.parametrize("name,beta", [("median", 0.1), ("trimmed_mean", 0.1),
                                       ("trimmed_mean", 0.3)])
def test_half_and_double_match_reference_bitwise(dtype, m, name, beta):
    import jax

    x = _x(m, shape=(5, 9), seed=m)
    x[0, 0, 0] = np.nan
    x[:, 0, 1] = 0.0
    x[: m // 2, 0, 1] = -0.0
    x[: max(1, m // 4), 0, 2] = np.inf
    x[:, 0, 3] = 3e-5 * np.sign(x[:, 0, 3])  # f16 subnormals
    t = torch.from_numpy(x).to(dtype)
    got = A.get_aggregator(name, beta)(t)
    with jax.enable_x64(True):
        want = np.asarray(JA.get_aggregator(name, beta)(_as_jax(x, dtype)))
    assert got.dtype == dtype and got.shape == want.shape == (5, 9)
    g, w = got.numpy(), want
    assert np.array_equal(np.isnan(g), np.isnan(w))
    if name == "trimmed_mean" and int(beta * m) == 0:  # the plain mean: a sum's order
        np.testing.assert_allclose(g, w, **TOL)
        return
    ints = np.int16 if dtype == torch.float16 else np.int64
    assert np.array_equal(np.where(np.isnan(g), 0, g).view(ints),
                          np.where(np.isnan(w), 0, w).astype(g.dtype).view(ints))


@pytest.mark.parametrize("name", ["median", "trimmed_mean"])
def test_empty_leaf_takes_no_kernel_and_matches_reference(name, monkeypatch):
    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import selection_network as SN

    def refuse(*args, **kwargs):
        raise AssertionError("an empty leaf reached a kernel or the network")

    for mod, fn in ((robust_agg, "median_many"), (robust_agg, "trimmed_mean_many"),
                    (SN, "median_select"), (SN, "trimmed_mean_select")):
        monkeypatch.setattr(mod, fn, refuse)
    for m, shape in ((10, (0,)), (10, (3, 0)), (70, (0,))):
        for dtype in (torch.float32, torch.float16, torch.float64):
            x = torch.zeros((m,) + shape, dtype=dtype)
            got = A.get_aggregator(name, 0.1)(x)
            want = JA.get_aggregator(name, 0.1)(jnp.zeros((m,) + shape))
            assert got.shape == tuple(want.shape) == shape and got.dtype == dtype
    tree = {"e": torch.zeros(10, 0), "f": torch.zeros(10, 4, 0, dtype=torch.float16)}
    out = A.tree_aggregate(tree, name, 0.1)
    assert out["e"].shape == (0,) and out["f"].shape == (4, 0)
    assert out["f"].dtype == torch.float16


@pytest.mark.parametrize("name", ["median", "trimmed_mean"])
def test_mixed_dtype_tree_matches_reference_bitwise(name):
    import jax

    rng = np.random.default_rng(11)
    leaves = {"h": (rng.standard_normal((10, 7)), torch.float16),
              "d": (rng.standard_normal((10, 3, 2)), torch.float64),
              "f": (rng.standard_normal((10, 33)), torch.float32),
              "e": (np.zeros((10, 0)), torch.float16)}
    tree = {k: torch.from_numpy(v).to(dt) for k, (v, dt) in leaves.items()}
    got = A.tree_aggregate(tree, name, 0.1)
    with jax.enable_x64(True):
        want = JA.tree_aggregate(
            {k: jnp.asarray(v, dtype={torch.float16: jnp.float16, torch.float64: jnp.float64,
                                      torch.float32: jnp.float32}[dt])
             for k, (v, dt) in leaves.items()}, name, 0.1)
        want = {k: np.asarray(v) for k, v in want.items()}
    for k in tree:
        assert got[k].dtype == tree[k].dtype and got[k].shape == want[k].shape
        assert np.array_equal(got[k].numpy(), want[k]), k
