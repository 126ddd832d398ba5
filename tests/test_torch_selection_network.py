"""Parity of the port's selection network, sort oracle, kernel wrappers
and ops dispatch with the JAX reference (CPU; the reference's Pallas
kernels run in interpret mode as tests/test_kernels.py runs them).

Contract: the median (plain and fused) is bitwise the reference's; the
trimmed mean is bitwise the reference's EAGER executor and within 1 ulp
of ``trimmed_mean_pallas`` (jitted, XLA turns the division by
m - 2*trim into a multiply by its reciprocal).  Comparison is bitwise on
the raw bit patterns (so -0 != +0), with NaN matched by position.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import robust_agg as jra
from repro.kernels import selection_network as JSN
from repro_torch.kernels import ops, ref, robust_agg
from repro_torch.kernels import selection_network as SN

torch.set_num_threads(2)

MS = [2, 3, 5, 8, 16, 17, 32]  # the tests/test_kernels.py sweep
DTYPES = ["float32", "bfloat16"]


def _rows(m, n, seed, dtype="float32"):
    """N(0,1) rows with adversarial columns: ±1e30 rows, a NaN, mixed ±0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    if n >= 4:
        x[: max(1, m // 4), 0] = 1e30
        x[: max(1, m // 4), 1] = -1e30
        x[m // 2, 2] = np.nan
        x[:, 3] = np.where(rng.random(m) < 0.5, -0.0, 0.0)
    return x


def _both(x_np, dtype):
    """The same values as a jax and a torch array of ``dtype``."""
    jx = jnp.asarray(x_np, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    return jx, tx


def _bits(a):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))
    return np.where(np.isnan(a), np.float32(np.nan), a).astype(np.float32).view(np.int32)


def assert_bitwise(got, want, msg=""):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    bad = np.flatnonzero(g != w)
    assert bad.size == 0, f"{msg}: {bad.size} mismatches, first at {bad[:5]}"


def assert_within_ulp(got, want, ulps=1):
    g = np.asarray(got.float()).astype(np.float32)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert (np.isnan(g) == np.isnan(w)).all()
    ok = ~np.isnan(g)
    diff = np.abs(g[ok].view(np.int32).astype(np.int64) - w[ok].view(np.int32).astype(np.int64))
    assert diff.max(initial=0) <= ulps, diff.max()


# ----------------------------------------------------------- generator


def test_comparator_programs_equal_reference():
    for m in range(2, 65):
        assert SN.batcher_network(m) == JSN.batcher_network(m)
        assert SN.median_program(m).comparators == JSN.median_program(m).comparators
        for trim in range(0, (m + 1) // 2):
            assert SN.trimmed_program(m, trim).comparators == \
                JSN.trimmed_program(m, trim).comparators, (m, trim)
            assert SN.fused_program(m, trim).comparators == \
                JSN.fused_program(m, trim).comparators, (m, trim)
    for m in (5, 32):
        got, want = SN.median_program(m, "transposition"), JSN.median_program(m, "transposition")
        assert (got.comparators, got.full_size) == (want.comparators, want.full_size)


def test_minmax_match_jnp_on_nan_and_signed_zero():
    a = np.array([-0.0, 0.0, np.nan, 1.0, -0.0, 3.0], np.float32)
    b = np.array([0.0, -0.0, 1.0, np.nan, -0.0, -2.0], np.float32)
    for dtype in DTYPES:
        (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
        assert_bitwise(SN.ieee_minimum(ta, tb), jnp.minimum(ja, jb), dtype)
        assert_bitwise(SN.ieee_maximum(ta, tb), jnp.maximum(ja, jb), dtype)


# ----------------------------------------------------------- executors


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", MS + [40, 64])
def test_median_bitwise_vs_reference(m, dtype):
    jx, tx = _both(_rows(m, 300, seed=m), dtype)
    want = JSN.median_select(jx)
    assert_bitwise(SN.median_select(tx), want, "median_select")
    assert_bitwise(robust_agg.median(tx), want, "robust_agg.median (cpu)")
    trim = max(1, m // 10) if m > 2 else 0
    med, tm = SN.median_and_trimmed_select(tx, trim)
    assert_bitwise(med, want, "fused median")
    assert_bitwise(tm, JSN.trimmed_mean_select(jx, trim), "fused trimmed mean")


# Interpret-mode Pallas in bf16 compiles for seconds at m >= 32 (the
# eager network covers bf16 there bitwise), so bf16 stops at m = 17.
@pytest.mark.parametrize("m,dtype", [(m, "float32") for m in MS]
                         + [(m, "bfloat16") for m in MS if m <= 17])
def test_median_bitwise_vs_pallas(m, dtype):
    jx, tx = _both(_rows(m, 300, seed=100 + m), dtype)
    assert_bitwise(SN.median_select(tx), jra.median_pallas(jx, block=256), "pallas")
    med, _ = robust_agg.fused_median_trimmed(tx, 0)
    assert_bitwise(med, jra.fused_median_trimmed_pallas(jx, 0, block=256)[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,trim", [(5, 1), (10, 1), (13, 1), (16, 3), (17, 8),
                                    (32, 8), (40, 2), (41, 4), (64, 31)])
def test_trimmed_mean_bitwise_vs_eager_and_ulp_vs_pallas(m, trim, dtype):
    jx, tx = _both(_rows(m, 300, seed=7 * m + trim), dtype)
    got = SN.trimmed_mean_select(tx, trim)
    assert_bitwise(got, JSN.trimmed_mean_select(jx, trim), "eager network")
    assert_bitwise(robust_agg.trimmed_mean(tx, trim), got, "wrapper (cpu)")
    if dtype == "float32" or m <= 17:  # see test_median_bitwise_vs_pallas
        assert_within_ulp(got, jra.trimmed_mean_pallas(jx, trim=trim, block=256))


@pytest.mark.parametrize("m,trim,dtype", [(5, 1, "float32"), (10, 1, "float32"),
                                          (13, 1, "float32"), (16, 3, "float32"),
                                          (17, 8, "float32"), (32, 3, "float32"),
                                          (10, 1, "bfloat16"), (17, 2, "bfloat16")])
def test_fused_many_vs_pallas_and_eager(m, trim, dtype):
    """fused_median_trimmed_many (CPU path) over ragged leaves against the
    reference's fused Pallas kernel (interpret mode) and eager executor.
    The leaves all pad to one Pallas block, so each case compiles once."""
    pairs = [_both(_rows(m, n, seed=31 * m + n), dtype) for n in (1, 7, 200)]
    meds, tms = robust_agg.fused_median_trimmed_many([tx for _, tx in pairs], trim)
    for (jx, _), med, tm in zip(pairs, meds, tms):
        want_med, want_tm = jra.fused_median_trimmed_pallas(jx, trim, block=256)
        assert_bitwise(med, want_med, "fused median vs pallas")
        assert_within_ulp(tm, want_tm)
        eager_med, eager_tm = JSN.median_and_trimmed_select(jx, trim)
        assert_bitwise(med, eager_med, "fused median vs eager")
        assert_bitwise(tm, eager_tm, "fused trimmed mean vs eager")


@pytest.mark.parametrize("n", [1, 100, 128, 1000, 4097])
def test_ragged_n_and_rank_select(n):
    jx, tx = _both(_rows(7, n, seed=n), "float32")
    assert_bitwise(SN.median_select(tx), JSN.median_select(jx))
    for r in (0, 3, 6):
        assert_bitwise(SN.rank_select(tx, r), JSN.rank_select(jx, r))


def test_sort_oracle_matches_reference():
    from repro.kernels import ref as jref

    for m in (4, 5, 16):
        x = np.random.default_rng(m).standard_normal((m, 200)).astype(np.float32)
        jx, tx = _both(x, "float32")
        assert_bitwise(ref.median_ref(tx), jref.median_ref(jx))
        # f32 means summed in different orders: a few ulps of the row scale
        np.testing.assert_allclose(ref.trimmed_mean_ref(tx, 0.2),
                                   jref.trimmed_mean_ref(jx, 0.2), rtol=1e-6, atol=1e-6)


def test_kernel_adversarial_rows_keep_median_honest():
    rng = np.random.default_rng(2)
    honest = rng.standard_normal((9, 300)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([honest, np.full((4, 300), 1e30, np.float32)]))
    assert (robust_agg.median(x).numpy() <= honest.max(0)).all()


# ----------------------------------------------------------------- ops


def test_ops_backends_agree_and_guard():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((9, 3, 5)).astype(np.float32))
    net = ops.robust_aggregate(x, "median")
    assert net.shape == (3, 5)
    torch.testing.assert_close(ops.robust_aggregate(x, "median", backend="sort"), net)
    assert torch.equal(ops.robust_aggregate(x, "median", backend="cuda"), net)
    med, tm = ops.fused_median_trimmed(x, beta=0.2)
    assert torch.equal(med, net)
    assert torch.equal(tm, ops.robust_aggregate(x, "trimmed_mean", beta=0.2))
    big = torch.zeros(65, 4)
    for backend in ("network", "cuda"):
        with pytest.raises(ValueError, match="m <= 64"):
            ops.robust_aggregate(big, "median", backend=backend)
    assert ops.robust_aggregate(big, "median").shape == (4,)  # auto -> sort
    with pytest.raises(ValueError):
        ops.robust_aggregate(x, "median", backend="pallas")


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        robust_agg.median(torch.zeros(3, 4, 5))
    with pytest.raises(TypeError):
        robust_agg.median(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        robust_agg.median(torch.zeros(4, 3).T)
    with pytest.raises(ValueError, match="trim"):
        robust_agg.trimmed_mean(torch.zeros(4, 3), 2)
    with pytest.raises(ValueError, match="device"):
        robust_agg.median(torch.zeros(3, 4).as_subclass(_OtherDevice))
    # a meta tensor is a dry-run's stand-in: the kernel op's shapes, no launch
    out = robust_agg.median(torch.zeros(3, 4, device="meta"))
    assert out.shape == (4,) and out.is_meta


class _OtherDevice(torch.Tensor):
    """A CPU tensor that reports a device the kernels do not take."""

    @property
    def device(self):
        return torch.device("xpu", 0)
