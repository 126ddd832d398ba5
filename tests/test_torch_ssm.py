"""The port's Mamba-2 SSD mixer and causal conv (repro_torch.models.ssm)
against the reference's (repro.models.ssm), on the CPU, in float32 on
numpy inputs.

Tolerance: 1e-5 absolute on values of magnitude ~1 (observed ~1e-6: the
einsums contract in other orders), gradients 1e-5 relative to their
largest entry; ``_segsum``'s -inf entries are equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RS
from repro_torch.models import ssm

torch.set_num_threads(2)

TOL = 1e-5


def _inputs(b, s, h, p, n, seed):
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    loga = -np.abs(rs.standard_normal((b, s, h)) * 0.3).astype(np.float32)
    bm = (rs.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rs.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    h0 = (rs.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    return x, loga, bm, cm, h0


def test_segsum_matches_reference():
    a = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(np.float32)
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(RS._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=TOL, rtol=0)


@pytest.mark.parametrize("s,chunk", [(16, 8), (24, 8), (13, 8), (5, 8), (40, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(s, chunk, with_h0):
    """Output and final state, s a multiple of the chunk and not (padded)."""
    x, loga, bm, cm, h0 = _inputs(2, s, 3, 4, 5, seed=s + chunk)
    h0 = h0 if with_h0 else None
    y_r, st_r = RS.ssd_chunked(*map(jnp.asarray, (x, loga, bm, cm)), chunk=chunk,
                               h0=None if h0 is None else jnp.asarray(h0))
    y, st = ssm.ssd_chunked(*map(torch.from_numpy, (x, loga, bm, cm)), chunk=chunk,
                            h0=None if h0 is None else torch.from_numpy(h0))
    assert tuple(y.shape) == (2, s, 3, 4) and tuple(st.shape) == (2, 3, 4, 5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=TOL, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), atol=TOL, rtol=0)


def test_ssd_chunked_bf16_input_keeps_dtype_and_f32_state():
    x, loga, bm, cm, _ = _inputs(1, 12, 2, 4, 3, seed=9)
    y, st = ssm.ssd_chunked(torch.from_numpy(x).bfloat16(), torch.from_numpy(loga),
                            torch.from_numpy(bm).bfloat16(), torch.from_numpy(cm).bfloat16(),
                            chunk=8)
    y_r, st_r = RS.ssd_chunked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(loga),
                               jnp.asarray(bm, jnp.bfloat16), jnp.asarray(cm, jnp.bfloat16),
                               chunk=8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_r.astype(jnp.float32)),
                               atol=1e-2, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), atol=1e-5, rtol=0)


def test_ssd_chunked_gradients_match_reference():
    """Gradients of sum(y * cot) + sum(final state * cot2) w.r.t. x, loga, B,
    C and h0, over a padded sequence (13 steps in chunks of 8): finite (no
    NaN from the -inf above the diagonal) and equal to jax.grad's."""
    x, loga, bm, cm, h0 = _inputs(2, 13, 3, 4, 5, seed=3)
    rs = np.random.default_rng(4)
    cot, cot2 = rs.standard_normal(x.shape).astype(np.float32), \
        rs.standard_normal(h0.shape).astype(np.float32)

    def ref(*a):
        y, st = RS.ssd_chunked(*a[:4], chunk=8, h0=a[4])
        return jnp.sum(y * cot) + jnp.sum(st * cot2)

    want = jax.grad(ref, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, loga, bm, cm, h0)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, loga, bm, cm, h0)]
    y, st = ssm.ssd_chunked(*leaves[:4], chunk=8, h0=leaves[4])
    (torch.sum(y * torch.from_numpy(cot)) + torch.sum(st * torch.from_numpy(cot2))).backward()
    for name, t, g in zip(("x", "loga", "B", "C", "h0"), leaves, want):
        g = np.asarray(g)
        assert np.isfinite(t.grad.numpy()).all(), name
        np.testing.assert_allclose(t.grad.numpy(), g, atol=TOL * max(1.0, np.abs(g).max()),
                                   rtol=0, err_msg=name)


def test_ssd_decode_step_matches_reference_and_the_chunked_scan():
    x, loga, bm, cm, h0 = _inputs(2, 3, 3, 4, 5, seed=6)
    st_r, st = jnp.asarray(h0), torch.from_numpy(h0)
    ys = []
    for t in range(3):
        y_r, st_r = RS.ssd_decode_step(st_r, *(jnp.asarray(a[:, t]) for a in (x, loga, bm, cm)))
        y, st = ssm.ssd_decode_step(st, *(torch.from_numpy(a[:, t]) for a in (x, loga, bm, cm)))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=TOL, rtol=0)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_r), atol=TOL, rtol=0)
        ys.append(y)
    y_full, st_full = ssm.ssd_chunked(*map(torch.from_numpy, (x, loga, bm, cm)), chunk=8,
                                      h0=torch.from_numpy(h0))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_full.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(st.numpy(), st_full.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("s", [1, 2, 3, 9])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_reference(s, with_prev, dtype):
    """(silu(y), new_prev) with and without ``prev``, s < W - 1 included."""
    rs = np.random.default_rng(s)
    x = rs.standard_normal((2, s, 6)).astype(np.float32)
    w = (rs.standard_normal((4, 6)) * 0.5).astype(np.float32)
    prev = rs.standard_normal((2, 3, 6)).astype(np.float32) if with_prev else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    y_r, p_r = RS.causal_conv1d(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                None if prev is None else jnp.asarray(prev, jdt))
    y, p = ssm.causal_conv1d(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                             None if prev is None else torch.from_numpy(prev).to(tdt))
    assert y.dtype == p.dtype == tdt and tuple(p.shape) == (2, 3, 6)
    tol = TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_r.astype(jnp.float32)),
                               atol=tol, rtol=0)
    np.testing.assert_array_equal(p.float().numpy(), np.asarray(p_r.astype(jnp.float32)))
