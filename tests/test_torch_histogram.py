"""The streaming sketch's kernels (B4 min/max, B5 histogram) and the
streaming aggregator: the port's plain versions against the reference's
Pallas kernels in interpret mode and its scatter path, on the same numpy
chunks (CPU).

Tolerances: min/max and bin counts are held bitwise/exactly.  The port
adds each bin's sum in row order (as its CUDA kernel does); the
reference's kernel and scatter path add in XLA's order.  So a finite bin
sum is held to the worst-case rounding error of summing that bin in any
order, ``(rows - 1) * 2^-24 * sum(|x|)`` over the bin, and non-finite
sums must be equal.  On the O(1) Gaussian columns that bound is below the
reference's own ``atol=1e-3`` (tests/test_fed.py), which is asserted too.
Streaming estimators are held to 1e-6 (median, bin centres from the same
edges) and 1e-5 relative (means: torch and XLA sum rows in different
orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import streaming as RS
from repro.kernels import histogram_agg as RH
from repro_torch.fed import streaming as S
from repro_torch.kernels import histogram_agg as H

torch.set_num_threads(2)


def _chunk(rows, n, seed, dtype=torch.float32, adversarial=True):
    """(torch chunk, the same values as float32 numpy).  Adversarial
    columns: ±1e30 rows, a NaN, mixed ±0, a constant (zero-width) column,
    a +inf and a -inf row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * 3).astype(np.float32)
    if adversarial and n >= 6:
        x[: max(1, rows // 4), 0] = 1e30
        x[rows // 2:, 0] = -1e30
        x[rows // 2, 1] = np.nan
        x[:, 2] = np.where(rng.random(rows) < 0.5, -0.0, 0.0)
        x[:, 3] = 1.25
        x[0, 4] = np.inf
        x[-1, 5] = -np.inf
    t = torch.from_numpy(x).to(dtype)
    return t, t.float().numpy()


def _jnp(x_np, dtype):
    return jnp.asarray(x_np, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _assert_bitequal(got: np.ndarray, want: np.ndarray):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    gn, wn = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(got[~gn].view(np.int32), want[~wn].view(np.int32))


def _assert_sums_close(got, want, x_np, lo, width, nbins):
    """Finite sums within any summation order's rounding bound of each
    other; NaN/±inf sums equal."""
    got, want = np.asarray(got), np.asarray(want)
    rows, n = x_np.shape
    idx = H.bin_index(torch.from_numpy(x_np), torch.from_numpy(lo), torch.from_numpy(width),
                      nbins).numpy()
    absx = np.where(np.isfinite(x_np), np.abs(x_np), 0).astype(np.float64)
    mass = np.zeros((nbins, n))
    np.add.at(mass, (idx, np.broadcast_to(np.arange(n), idx.shape)), absx)
    bound = (rows - 1) * 2.0 ** -24 * mass
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    assert (np.abs(got[fin].astype(np.float64) - want[fin]) <= bound[fin]).all()
    gauss = np.isfinite(x_np).all(0) & (np.abs(x_np).max(0) < 100)
    np.testing.assert_allclose(got[:, gauss], want[:, gauss], rtol=0, atol=1e-3)


def _edges(x_np, nbins):
    lo = np.min(x_np, 0)
    hi = np.max(x_np, 0)
    with np.errstate(invalid="ignore", over="ignore"):
        return lo, ((hi - lo) / np.float32(nbins)).astype(np.float32)


# --------------------------------------------------------------- B4 minmax


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(1, 7), (19, 300), (64, 133)])
def test_minmax_plain_bitwise_vs_minmax_pallas(rows, n, dtype):
    x, x_np = _chunk(rows, n, seed=rows * 31 + n, dtype=dtype)
    lo, hi = H.minmax(x)  # CPU tensor: the plain version
    jlo, jhi = RH.minmax_pallas(_jnp(x_np, dtype), block=128, interpret=True)
    _assert_bitequal(lo.numpy(), np.asarray(jlo))
    _assert_bitequal(hi.numpy(), np.asarray(jhi))
    assert lo.dtype == hi.dtype == torch.float32
    signs = np.signbit(x_np[:, 2]) if n >= 6 else np.zeros(1, bool)
    if signs.any() and not signs.all():  # mixed ±0: -0 < +0 on both sides
        assert np.signbit(lo[2].item()) and not np.signbit(hi[2].item())


def test_minmax_wrapper_is_the_plain_version_on_cpu():
    x, _ = _chunk(33, 40, seed=2)
    for got, want in zip(H.minmax(x), H.minmax_plain(x)):
        _assert_bitequal(got.numpy(), want.numpy())


# ------------------------------------------------------------ B5 histogram


@pytest.mark.parametrize("with_sums", [True, False])
@pytest.mark.parametrize("nbins", [2, 32, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_histogram_plain_vs_histogram_pallas(dtype, nbins, with_sums):
    rows, n = 33, 261  # n not a multiple of the 128-lane block
    x, x_np = _chunk(rows, n, seed=nbins, dtype=dtype)
    lo, width = _edges(x_np, nbins)
    c, s = H.histogram(x, torch.from_numpy(lo), torch.from_numpy(width), nbins,
                       with_sums=with_sums)
    jc, js = RH.histogram_pallas(_jnp(x_np, dtype), jnp.asarray(lo), jnp.asarray(width),
                                 nbins=nbins, block=128, interpret=True,
                                 with_sums=with_sums)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert c.numpy().sum(0).tolist() == [float(rows)] * n
    if not with_sums:
        assert s is None and js is None
        return
    _assert_sums_close(s.numpy(), js, x_np, lo, width, nbins)


@pytest.mark.parametrize("nbins", [2, 32, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_histogram_plain_vs_reference_scatter_path(dtype, nbins):
    rows, n = 40, 130
    x, x_np = _chunk(rows, n, seed=100 + nbins, dtype=dtype)
    lo, width = _edges(x_np, nbins)
    c, s = H.histogram(x, torch.from_numpy(lo), torch.from_numpy(width), nbins)
    jc, js = RH.hist_update(*RH.hist_init(n, nbins), _jnp(x_np, dtype),
                            jnp.asarray(lo), jnp.asarray(width))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    _assert_sums_close(s.numpy(), js, x_np, lo, width, nbins)


def test_bin_index_clips_in_float_like_both_reference_paths():
    # ±inf and NaN quotients: x - lo overflowing to ±inf, NaN rows, ±inf rows
    nb = 8
    x = np.array([[3e38, -3e38, np.nan, np.inf, -np.inf, 1.0, 0.5, -0.0],
                  [1.0] * 8], np.float32)
    lo = np.array([-3e38, 3e38, 0, 0, 0, 0, 0, 0], np.float32)
    w = np.array([1e37, 1e37, 1, 1, 1, 0, 0.1, 1], np.float32)
    got = H.bin_index(torch.from_numpy(x), torch.from_numpy(lo), torch.from_numpy(w), nb)
    want_jnp = np.asarray(RH.bin_index(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(w), nb))
    np.testing.assert_array_equal(got.numpy(), want_jnp)
    assert got[0, 0] == nb - 1 and got[0, 1] == 0 and got[0, 2] == 0 and got[0, 3] == nb - 1
    c, _ = H.histogram(torch.from_numpy(x), torch.from_numpy(lo), torch.from_numpy(w), nb)
    jc, _ = RH.histogram_pallas(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(w), nbins=nb,
                                block=128, interpret=True)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_histogram_rejects_bad_inputs():
    x = torch.zeros(4, 3)
    lo = torch.zeros(3)
    with pytest.raises(ValueError, match="lo"):
        H.histogram(x, torch.zeros(2), lo, 4)
    with pytest.raises(TypeError):
        H.minmax(x.double())
    with pytest.raises(ValueError, match="rows"):
        H.minmax(torch.zeros(0, 3))
    with pytest.raises(ValueError, match="contiguous"):
        H.minmax(torch.zeros(3, 4).t())


# --------------------------------------------------------------- streaming


@pytest.mark.parametrize("method", ["median", "trimmed_mean", "mean"])
@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
def test_aggregate_array_chunked_matches_reference(method, ref_backend):
    """The port's plain kernels against both reference paths: the scatter
    path (``xla``) and the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(9)
    x_np = (rng.standard_normal((100, 23)) * 2).astype(np.float32)
    got = S.aggregate_array_chunked(torch.from_numpy(x_np), method, 0.1, 16,
                                    S.SketchConfig(nbins=64)).numpy()
    want = np.asarray(RS.aggregate_array_chunked(
        jnp.asarray(x_np), method, 0.1, 16,
        RS.SketchConfig(nbins=64, backend=ref_backend, block=128)))
    if method == "mean":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk_rows", [7, 16, 1000])
def test_chunk_invariance(chunk_rows):
    """Streaming over chunks (uneven tail included) equals the single-shot
    sketch: the estimator is a function of the histogram alone."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((100, 23)).astype(np.float32))
    cfg = S.SketchConfig(nbins=64)
    whole = S.aggregate_array_chunked(x, "median", chunk_rows=1000, cfg=cfg)
    chunked = S.aggregate_array_chunked(x, "median", chunk_rows=chunk_rows, cfg=cfg)
    assert torch.equal(whole, chunked)
    counts, _, lo, width = H.sketch_array(x, 64, with_sums=False)
    assert torch.equal(whole, H.median_from_hist(counts, lo, width, 100))


def test_streaming_multi_shares_one_sketch_and_is_within_one_bin():
    rng = np.random.default_rng(10)
    x = torch.from_numpy((rng.standard_normal((61, 11)) * 2).astype(np.float32))
    bounds = [(s, min(s + 9, 61)) for s in range(0, 61, 9)]
    out = S.streaming_aggregate_multi(lambda j: x[bounds[j][0]:bounds[j][1]], len(bounds),
                                      11, ("median", "trimmed_mean", "mean"), 0.1,
                                      S.SketchConfig(nbins=128))
    xs = np.sort(x.numpy(), 0)
    w = (xs[-1] - xs[0]) / 128
    assert (np.abs(out["median"].numpy() - np.median(xs, 0)) <= w * 1.0001 + 1e-6).all()
    assert (np.abs(out["trimmed_mean"].numpy() - xs[6:55].mean(0)) <= w + 1e-6).all()
    np.testing.assert_allclose(out["mean"].numpy(), xs.mean(0), rtol=1e-5, atol=1e-6)


def test_no_fallback_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA: the default device is legitimately the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.minmax_init(3)  # the sketch's state defaults to the card
    with pytest.raises(RuntimeError, match="CUDA"):
        H.load()
