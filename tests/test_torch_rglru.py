"""The port's RG-LRU (repro_torch.models.rglru) against the reference's
(repro.models.rglru), on the CPU, in float32 on numpy inputs.

The port's scan is the odd/even recursion of ``jax.lax.associative_scan``
on strided slices; it combines the same pairs in the same order, and the
gates' matmuls round alike, so the results agree to ~1 ulp: observed
4.8e-7 at most up to S = 300.  Tolerance 1e-6 absolute on values of
magnitude < 3; gradients 1e-5 relative to their largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as RR
from repro_torch.models import rglru

torch.set_num_threads(2)

TOL = 1e-6
C = 16


def _inputs(b, s, seed):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((b, s, C)).astype(np.float32)
    w = [(rs.standard_normal((C, C)) * 0.3).astype(np.float32),
         (rs.standard_normal(C) * 0.1).astype(np.float32),
         (rs.standard_normal((C, C)) * 0.3).astype(np.float32),
         (rs.standard_normal(C) * 0.1).astype(np.float32),
         rs.standard_normal(C).astype(np.float32)]
    h0 = rs.standard_normal((b, C)).astype(np.float32)
    return x, w, h0


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 7, 8, 16, 31, 64, 127, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(s, with_h0):
    x, w, h0 = _inputs(2, s, seed=s)
    h0 = h0 if with_h0 else None
    y_r, h_r = RR.rglru_scan(jnp.asarray(x), *map(jnp.asarray, w),
                             None if h0 is None else jnp.asarray(h0))
    y, h = rglru.rglru_scan(torch.from_numpy(x), *map(torch.from_numpy, w),
                            None if h0 is None else torch.from_numpy(h0))
    assert tuple(y.shape) == (2, s, C) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=TOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), atol=TOL, rtol=0)


def test_associative_scan_is_jax_order_on_a_noncommutative_combine():
    """combine(a, b) = (31 a + b) mod 65521 is not associative, so equal
    results mean the same bracketing as jax.lax.associative_scan (odd and
    even lengths, powers of two and one past them)."""
    for s in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 17, 33):
        codes = np.arange(1, s + 1, dtype=np.int32) * 977 % 65521
        want = jax.lax.associative_scan(lambda a, b: (a * 31 + b) % 65521,
                                        jnp.asarray(codes), axis=0)
        got = rglru.associative_scan(lambda a, b: ((a[0] * 31 + b[0]) % 65521,),
                                     (torch.from_numpy(codes).long(),), dim=0)[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rglru_gradients_match_reference():
    x, w, h0 = _inputs(2, 37, seed=11)
    cot = np.random.default_rng(12).standard_normal((2, 37, C)).astype(np.float32)

    def ref(*a):
        y, h = RR.rglru_scan(a[0], *a[1:6], a[6])
        return jnp.sum(y * cot) + jnp.sum(h)

    want = jax.grad(ref, argnums=tuple(range(7)))(*map(jnp.asarray, [x] + w + [h0]))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x] + w + [h0]]
    y, h = rglru.rglru_scan(leaves[0], *leaves[1:6], leaves[6])
    (torch.sum(y * torch.from_numpy(cot)) + torch.sum(h)).backward()
    for name, t, g in zip(("x", "w_a", "b_a", "w_x", "b_x", "lam", "h0"), leaves, want):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, atol=1e-5 * max(1.0, np.abs(g).max()),
                                   rtol=0, err_msg=name)


def test_rglru_decode_step_matches_reference_and_the_scan():
    x, w, h0 = _inputs(3, 4, seed=13)
    st_r, st = jnp.asarray(h0), torch.from_numpy(h0)
    ys = []
    for t in range(4):
        y_r, st_r = RR.rglru_decode_step(st_r, jnp.asarray(x[:, t:t + 1]), *map(jnp.asarray, w))
        y, st = rglru.rglru_decode_step(st, torch.from_numpy(x[:, t:t + 1]),
                                        *map(torch.from_numpy, w))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=TOL, rtol=0)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_r), atol=TOL, rtol=0)
        ys.append(y)
    y_full, h_full = rglru.rglru_scan(torch.from_numpy(x), *map(torch.from_numpy, w),
                                      torch.from_numpy(h0))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.numpy(), h_full.numpy(), atol=1e-5, rtol=0)
    assert rglru.RG_LRU_C == RR.RG_LRU_C == 8.0
