"""The port's MoE FFN (repro_torch.models.moe) against the reference's
(repro.models.moe), on the CPU.

Routing is held EXACTLY: the router probabilities are injected into the
reference (its softmax returns them) and its dense dispatch / combine
tensors are read from the einsums that consume them; the port's
:func:`moe.route` on the same probabilities, expanded to the dense form,
must equal both bit for bit (capacity drops included, top-k 1, 2 and 8).

The layer end to end (y, the aux loss and their gradients) is held within
the transformer tests' tolerances (f32 1e-5 absolute, bf16 1e-2; gradients
in bf16 relative to their largest entry, 2e-2) on inputs whose top-k
probabilities are separated by more than 1e-4 (asserted), so that a
different expert order there would be a port fault, not rounding.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.models import moe as RM
from repro_torch import configs
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import moe_combine as MC
from repro_torch.models import moe

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _ref_dispatch_combine(monkeypatch, probs, top_k, d=8, ffn=8):
    """The reference's (dispatch, combine) for injected ``probs`` (B, S, E)."""
    b, s, e = probs.shape
    seen = {}
    real_einsum = RM.jnp.einsum

    def einsum(spec, *ops, **kw):
        if spec == "bsec,bsd->ebcd":
            seen["dispatch"] = np.asarray(ops[0])
        if spec == "bsec,ebcd->bsd":
            seen["combine"] = np.asarray(ops[0])
        return real_einsum(spec, *ops, **kw)

    monkeypatch.setattr(RM.jax.nn, "softmax", lambda logits, axis=-1: jnp.asarray(probs))
    monkeypatch.setattr(RM.jnp, "einsum", einsum)
    rs = np.random.default_rng(0)
    w = [jnp.asarray(rs.standard_normal(sh).astype(np.float32))
         for sh in ((d, e), (e, d, ffn), (e, d, ffn), (e, ffn, d))]
    RM.moe_ffn(jnp.asarray(rs.standard_normal((b, s, d)).astype(np.float32)), *w, top_k)
    monkeypatch.undo()
    return seen["dispatch"], seen["combine"]


def _dense(r: moe.Routing, e: int, cap: int):
    b, s, k = r.expert.shape
    dispatch = np.zeros((b, s, e, cap), np.float32)
    combine = np.zeros((b, s, e, cap), np.float32)
    for bi, si, ki in zip(*np.nonzero(r.keep.numpy())):
        ex, sl = int(r.expert[bi, si, ki]), int(r.slot[bi, si, ki])
        dispatch[bi, si, ex, sl] += 1.0
        combine[bi, si, ex, sl] += float(r.weight[bi, si, ki])
    return dispatch, combine


def _probs(b, s, e, seed, skew=0.0, hot=1):
    """Softmax of N(0, 1) logits (numpy f64 -> f32); ``skew`` raises the
    first ``hot`` experts."""
    logits = np.random.default_rng(seed).standard_normal((b, s, e))
    logits[..., :hot] += skew
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("b,s,e,top_k,skew", [
    (2, 16, 4, 1, 0.0), (2, 32, 4, 1, 3.0),  # top-1, then most tokens on one expert
    (2, 16, 4, 2, 0.0), (3, 24, 4, 2, 2.5),  # granite / grok smoke's top-2
    (2, 32, 32, 8, 0.0), (1, 40, 32, 8, 4.0),  # granite's top-8 of 32
    (4, 1, 32, 8, 0.0),  # a decode step: cap 1, nothing dropped
])
def test_route_equals_reference_dispatch_and_combine(monkeypatch, b, s, e, top_k, skew):
    probs = _probs(b, s, e, seed=b * 100 + s + top_k, skew=skew)
    cap = moe.capacity(s, e, top_k)
    want_d, want_c = _ref_dispatch_combine(monkeypatch, probs, top_k)
    assert want_d.shape == (b, s, e, cap)
    r = moe.route(torch.from_numpy(probs), top_k, cap)
    got_d, got_c = _dense(r, e, cap)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_c, want_c)
    dropped = b * s * top_k - int(r.keep.sum())
    if skew >= 3.0:
        assert dropped > 0  # the capacity case is exercised
    if s == 1:
        assert cap == 1 and dropped == 0


def _layer_inputs(arch, dtype, seed):
    cfg = configs.get_smoke_config(arch)
    d, e, f, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert, cfg.moe.top_k
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((2, 16, d)).astype(np.float32)
    ws = [(rs.standard_normal(sh) * sd).astype(np.float32)
          for sh, sd in (((d, e), 0.05), ((e, d, f), 0.05), ((e, d, f), 0.05), ((e, f, d), 0.05))]
    # the top-k experts (and the next one) are separated by more than 1e-4,
    # on the inputs rounded to ``dtype``
    rounded = [torch.from_numpy(a).to(getattr(torch, dtype)).double().numpy() for a in (x, ws[0])]
    logits = rounded[0] @ rounded[1]
    p = np.sort(np.exp(logits - logits.max(-1, keepdims=True)), axis=-1)[..., ::-1]
    p /= p.sum(-1, keepdims=True)
    assert np.diff(-p[..., :k + 1], axis=-1).min() > 1e-4
    cot = rs.standard_normal((2, 16, d)).astype(np.float32)
    return k, x, ws, cot


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "grok_1_314b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_values_and_gradients_match_reference(arch, dtype):
    """y, aux, and the gradient of sum(y * cot) + aux w.r.t. x and the four
    weights, against jax.value_and_grad, at the smoke widths."""
    k, x, ws, cot = _layer_inputs(arch, dtype, seed=5)
    jdt = jnp.dtype(dtype)

    def ref_loss(x, *ws):
        y, aux = RM.moe_ffn(x, *ws, k)
        return jnp.sum(y.astype(jnp.float32) * cot) + aux, (y, aux)

    (_, (y_r, aux_r)), g_r = jax.value_and_grad(ref_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a).astype(jdt) for a in [x] + ws))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in [x] + ws]
    y, aux = moe.moe_ffn(*leaves, k)
    assert y.dtype == tdt and aux.dtype == torch.float32
    (torch.sum(y.float() * torch.from_numpy(cot)) + aux).backward()
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_r.astype(jnp.float32)), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(float(aux.detach()), float(aux_r), atol=TOL[dtype], rtol=0)
    for name, t, g in zip(("x", "w_router", "w_gate", "w_up", "w_down"), leaves, g_r):
        want = np.asarray(g.astype(jnp.float32))
        got = t.grad.float().numpy()
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, atol=GRAD_RTOL[dtype] * scale, rtol=0,
                                   err_msg=name)


def test_capacity_formula():
    """cap = min(S, max(4, round_up(int(cf·k·S/E), 4))), the reference's."""
    for s, e, k in ((1, 32, 8), (16, 32, 8), (32, 32, 8), (288, 32, 8), (16, 4, 2),
                    (7, 8, 2), (1024, 8, 2)):
        want = min(s, max(4, RM._round_up(int(1.25 * k * s / e), 4)))
        assert moe.capacity(s, e, k) == want


# ---------------------------------------------------------------------------
# the combine op (kernels/moe_combine.py): its plain route and autograd
# wiring against the gather-and-sum the layer used before it, kept here as
# the oracle
# ---------------------------------------------------------------------------


def _gather_and_sum(ye, rows, keep, weight, mine):
    """The combine as ``_experts`` wrote it before the op: every pair not
    kept gathers row 0 with weight 0, and autograd's gather backward
    accumulates the duplicates."""
    picked = ye[torch.where(keep, rows, torch.zeros_like(rows))].float()
    if mine is not None:
        weight = torch.where(mine, weight, torch.zeros_like(weight))
    return torch.sum(picked * weight[..., None], dim=2)


def _combine_inputs(b, s, e, top_k, hot, skew, split, dtype, seed):
    """(ye, rows, keep, mine, top_p, route keep, dy) for routing skewed to
    the first ``hot`` experts; ``split`` "experts" takes rank 1's half of
    the experts (``mine``), as ``moe_ffn`` under a model axis of 2."""
    d = 24
    cap = moe.capacity(s, e, top_k)
    r = moe.route(torch.from_numpy(_probs(b, s, e, seed, skew=skew, hot=hot)), top_k, cap)
    e0, el, mine = 0, e, None
    if split == "experts":
        el = e // 2
        e0 = el
        mine = (r.expert >= e0) & (r.expert < e0 + el)
    rows = ((r.expert - e0) * b + torch.arange(b)[:, None, None]) * cap + r.slot
    keep = r.keep if mine is None else r.keep & mine
    rs = np.random.default_rng(seed + 1)
    ye = torch.from_numpy(rs.standard_normal((el * b * cap, d)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rs.standard_normal((b, s, d)).astype(np.float32))
    dy[0, 0, :3] = torch.tensor([-0.0, 0.0, -1e-30])  # signed zeros and an underflow
    top_p = torch.from_numpy(rs.uniform(0.05, 1.0, (b, s, top_k)).astype(np.float32))
    return ye, rows, keep, mine, top_p, r.keep, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,e,top_k,hot,skew,split", [
    (2, 32, 32, 8, 8, 6.0, None),  # granite's top-8 of 32 with most pairs dropped
    (2, 32, 32, 8, 8, 6.0, "experts"),  # the same, rank 1 of split="experts"
    (3, 24, 4, 2, 1, 0.0, None),  # the smoke models' top-2
    (4, 1, 32, 8, 1, 0.0, None),  # a decode step: cap 1
])
def test_combine_matches_the_gather_and_sum(dtype, b, s, e, top_k, hot, skew, split):
    """y and d_ye bitwise (signs of zero included), d_weight within f32
    rounding, against the gather-and-sum on the CPU; no kernel runs."""
    ye, rows, keep, mine, top_p, route_keep, dy = _combine_inputs(
        b, s, e, top_k, hot, skew, split, dtype, seed=b * 10 + s)
    if skew:
        assert 1 - route_keep.float().mean() > 0.5  # more than half the pairs dropped
    if s == 1:
        assert moe.capacity(s, e, top_k) == 1
    MC.reset_launches()
    grads = []
    for fn in (_gather_and_sum, None):
        ye_l = ye.clone().requires_grad_(True)
        p_l = top_p.clone().requires_grad_(True)
        weight = torch.where(route_keep, p_l, torch.zeros_like(p_l))  # as route() weighs
        y = (_gather_and_sum(ye_l, rows, keep, weight, mine) if fn else
             MC.moe_combine(ye_l, rows, keep, weight))
        y.backward(dy)
        grads.append((y.detach(), ye_l.grad, p_l.grad))
    (y_w, dye_w, dp_w), (y_g, dye_g, dp_g) = grads
    assert y_g.dtype == torch.float32 and dye_g.dtype == dtype
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}
    assert torch.equal(y_g.view(torch.int32), y_w.view(torch.int32))
    assert torch.equal(dye_g.view(bits[dtype]), dye_w.view(bits[dtype]))
    assert torch.equal(dp_g[~keep], torch.zeros_like(dp_g[~keep]))
    torch.testing.assert_close(dp_g, dp_w, rtol=0, atol=1e-6 * float(dp_w.abs().max()))
    assert not any(MC.LAUNCHES.values())


def test_combine_rejects_what_it_cannot_take():
    ye, rows, keep = torch.zeros(8, 4), torch.zeros(2, 3, dtype=torch.int64), torch.ones(2, 3,
                                                                                        dtype=bool)
    with pytest.raises(ValueError):
        MC.moe_combine(ye, rows, keep, torch.zeros(2, 2))
    with pytest.raises(TypeError):
        MC.moe_combine(ye, rows.int(), keep, torch.zeros(2, 3))
    with pytest.raises(TypeError):
        MC.moe_combine(ye, rows, keep, torch.zeros(2, 3, dtype=torch.float64))


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "grok_1_314b"])
def test_moe_ffn_on_meta_tensors_gives_shapes_and_builds_nothing(monkeypatch, arch):
    """The dry-run's route: ``moe_ffn`` and its backward on meta stand-ins
    give the CPU run's shapes and dtypes through the ops' fake
    implementations; nothing is built, loaded or launched."""
    def refuse(*a, **kw):
        raise AssertionError("built on meta tensors")

    monkeypatch.setattr(kbuild, "build", refuse)
    monkeypatch.setattr(kbuild, "load", refuse)
    k, x, ws, _ = _layer_inputs(arch, "bfloat16", seed=5)
    MC.reset_launches()
    out = {}
    for dev in ("cpu", "meta"):
        leaves = [torch.from_numpy(a).to(torch.bfloat16).to(dev).requires_grad_(True)
                  for a in [x] + ws]
        y, aux = moe.moe_ffn(*leaves, k)
        (torch.sum(y.float()) + aux).backward()
        out[dev] = [(tuple(t.shape), t.dtype) for t in [y, aux] + [lf.grad for lf in leaves]]
        assert y.device.type == dev
    assert out["meta"] == out["cpu"]
    assert not any(MC.LAUNCHES.values()) and MC._LIB is None


def test_combine_under_vmap_of_grad_matches_autograd_per_item():
    """``vmap(grad(loss))`` through the op on the plain route (the layout
    robust_gd and local_update take a loss in) gives, item by item, the
    gradients that autograd gives: d_ye bitwise, d_weight within f32
    rounding."""
    rs = np.random.default_rng(3)
    n, r, d, b, s, k = 3, 40, 8, 2, 6, 2
    ye = torch.from_numpy(rs.standard_normal((n, r, d)).astype(np.float32))
    rows = torch.from_numpy(np.stack([rs.permutation(r)[:b * s * k].reshape(b, s, k)
                                      for _ in range(n)]))
    keep = torch.from_numpy(rs.uniform(size=(n, b, s, k)) > 0.4)
    weight = torch.from_numpy(rs.uniform(size=(n, b, s, k)).astype(np.float32))

    def loss(ye, rows, keep, weight):
        return torch.sum(MC.moe_combine(ye, rows, keep, weight) ** 2)

    d_ye, d_w = torch.func.vmap(torch.func.grad(loss, argnums=(0, 3)))(ye, rows, keep, weight)
    for i in range(n):
        ye_l, w_l = ye[i].clone().requires_grad_(True), weight[i].clone().requires_grad_(True)
        loss(ye_l, rows[i], keep[i], w_l).backward()
        assert torch.equal(d_ye[i], ye_l.grad)
        torch.testing.assert_close(d_w[i], w_l.grad, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "grok_1_314b"])
def test_moe_ffn_under_torch_func_grad_matches_autograd(arch):
    """``torch.func.grad`` of an MoE loss (distributed.py's round step takes
    its loss so) runs through the op and matches autograd's gradients."""
    k, x, ws, cot = _layer_inputs(arch, "float32", seed=9)
    leaves = [torch.from_numpy(a) for a in [x] + ws]
    cot = torch.from_numpy(cot)

    def loss(*leaves):
        y, aux = moe.moe_ffn(*leaves, k)
        return torch.sum(y.float() * cot) + aux

    got = torch.func.grad(loss, argnums=tuple(range(5)))(*leaves)
    want = [lf.clone().requires_grad_(True) for lf in leaves]
    loss(*want).backward()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.grad, rtol=1e-6, atol=1e-6 * float(w.grad.abs().max()))
