"""The port's MoE, SSM and hybrid RG-LRU decoder families
(repro_torch.models.transformer with models.moe / ssm / rglru) against the
reference's (repro.models.transformer), on the CPU.

granite-moe-1b-a400m and grok-1-314b (MoE), mamba2-2.7b (SSM) and
recurrentgemma-2b ((rec, rec, attn) + a 2-layer rec tail, local window
16) at their smoke widths, and recurrentgemma at 8 layers (two
super-blocks), in float32 and bfloat16.  The reference's parameters (its
own init) are carried over with ``convert.transformer_from_reference``;
tokens come from numpy.

Tolerances, absolute (the transformer tests'):
- logits, aux, loss: float32 1e-5 (observed <= 6e-7), bfloat16 1e-2
  (observed <= 8.8e-3 on mamba2's logits: every matmul and the conv round
  to bf16 in both packages, not always alike);
- gradients, leaf by leaf: float32 1e-5 and bfloat16 2e-2, each relative
  to the leaf's largest entry (at least 1);
- caches: the float32 states and bf16 windows as the logits; kpos
  (integers) exactly.
In bfloat16 a router whose k-th and (k+1)-th probabilities lie within
~2e-4 of each other picks its experts by rounding: the reference's own
jitted forward then differs from its eager (``jax.disable_jit``) forward
by up to 4e-2 on these smoke models, above the bf16 tolerance
(test_reference_bf16_router_flips_against_itself holds one such draw,
least margin ~1.3e-4).  So the MoE models' bf16 cases run on
token draws whose router margins (between consecutive top-(k+1)
probabilities, every layer and step) exceed ROUTER_MARGIN, asserted, and
a different expert choice there would be a port fault.
"""
import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.models import convert, moe
from repro_torch.models import transformer as T
from repro_torch.tree import ravel, tree_leaves_with_path

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ROUTER_MARGIN = 5e-4
FORWARD_SEED, PREFILL_SEED = 7, 45  # token draws (see the module doc)
NEAR_TIE_SEED = 2  # a draw whose least granite bf16 router margin is ~1.3e-4
FAMILIES = ("granite_moe_1b_a400m", "grok_1_314b", "mamba2_2_7b", "recurrentgemma_2b")
CASES = [(a, dt, None) for a in FAMILIES for dt in ("float32", "bfloat16")] + [
    ("recurrentgemma_2b", "float32", 8), ("recurrentgemma_2b", "bfloat16", 8)]
IDS = [f"{a}-{dt}" + (f"-{n}L" if n else "") for a, dt, n in CASES]


def _models(arch, dtype, n_layers=None, seed=0):
    over = dict(dtype=dtype, **({"n_layers": n_layers} if n_layers else {}))
    rc = dataclasses.replace(ref_get_smoke_config(arch), **over)
    pc = dataclasses.replace(configs.get_smoke_config(arch), **over)
    rp = RT.init_params(rc, jax.random.PRNGKey(seed))
    pp = convert.transformer_from_reference(pc, jax.tree.map(np.asarray, rp), device="cpu")
    return rc, pc, rp, pp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _ref_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


class _RouterMargins:
    """Inside ``with``: the smallest gap between consecutive top-(k+1)
    router probabilities the port's MoE layers routed on."""

    def __init__(self, monkeypatch):
        self.monkeypatch, self.least = monkeypatch, float("inf")

    def __enter__(self):
        real = moe.route

        def route(probs, top_k, cap):
            p = torch.sort(probs.detach().float(), dim=-1, descending=True).values
            self.least = min(self.least, float((p[..., :top_k] - p[..., 1:top_k + 1]).min()))
            return real(probs, top_k, cap)

        self.monkeypatch.setattr(moe, "route", route)
        return self

    def __exit__(self, *exc):
        self.monkeypatch.undo()

    def check(self, cfg):
        if cfg.moe is not None and cfg.dtype == "bfloat16":
            assert self.least > ROUTER_MARGIN, self.least


def _close_trees(got, want, tol, what, relative=False):
    """Port tree ``got`` leaf by leaf against the reference's ``want``."""
    want = _ref_leaves(want)
    got = dict(tree_leaves_with_path(got))
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for path, t in got.items():
        w = _np(want[path])
        assert tuple(t.shape) == w.shape, (what, path)
        if t.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]), err_msg=path)
            continue
        scale = max(1.0, float(np.abs(w).max())) if relative else 1.0
        np.testing.assert_allclose(_np(t), w, atol=tol * scale, rtol=0, err_msg=f"{what} {path}")


@pytest.mark.parametrize("arch,dtype,n_layers", CASES, ids=IDS)
def test_forward_loss_and_gradients_match_reference(monkeypatch, arch, dtype, n_layers):
    """forward's logits and aux, loss_fn (with the 0.01-weighted aux) and
    its gradient leaf by leaf."""
    rc, pc, rp, pp = _models(arch, dtype, n_layers)
    tok = _tokens((2, 12), rc.vocab, FORWARD_SEED)
    lab = _tokens((2, 12), rc.vocab, 2)
    want, want_aux = RT.forward(rp, jnp.asarray(tok), rc, remat=False, kv_block=0)
    with _RouterMargins(monkeypatch) as margins:
        got, aux = T.forward(pp, torch.from_numpy(tok), pc, kv_block=0)
    margins.check(pc)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (2, 12, rc.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=TOL[dtype], rtol=0)
    assert (float(aux) > 0) == (pc.moe is not None)
    batch = {"tokens": tok, "labels": lab}
    rloss, rgrad = jax.value_and_grad(
        lambda p: RT.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
                             remat=False, kv_block=0))(rp)
    leaves = [t.detach().requires_grad_(True) for _, t in tree_leaves_with_path(pp)]
    it = iter(leaves)
    req = jax.tree.map(lambda _: next(it), pp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    loss = T.loss_fn(req, {k: torch.from_numpy(v) for k, v in batch.items()}, pc, kv_block=0)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), atol=TOL[dtype], rtol=0)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    _close_trees(jax.tree.map(lambda _: next(it), pp,
                              is_leaf=lambda x: isinstance(x, torch.Tensor)),
                 rgrad, GRAD_TOL[dtype], "grad", relative=True)


@pytest.mark.parametrize("arch,dtype,n_layers", CASES, ids=IDS)
def test_prefill_and_decode_match_reference(monkeypatch, arch, dtype, n_layers):
    """prefill of a 14-token prompt at cache_len 17, then three decode_steps
    (positions 14-16: the last past recurrentgemma's local window of 16, so
    its ring buffer wraps): logits at every step and every cache leaf
    (attention k / v / kpos, the SSM's conv window and f32 state, the
    RG-LRU's conv window and f32 state) after prefill and after the chain;
    init_cache has the reference's tree."""
    rc, pc, rp, pp = _models(arch, dtype, n_layers)
    tok = _tokens((2, 14), rc.vocab, PREFILL_SEED)
    nxt = _tokens((3, 2, 1), rc.vocab, PREFILL_SEED + 1)
    rl, rcache = RT.prefill(rp, jnp.asarray(tok), rc, kv_block=0, cache_len=17)
    with _RouterMargins(monkeypatch) as margins:
        pl, pcache = T.prefill(pp, torch.from_numpy(tok), pc, kv_block=0, cache_len=17)
    np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL[dtype], rtol=0)
    _close_trees(pcache, rcache, TOL[dtype], "prefill cache")
    for i in range(3):
        rl, rcache = RT.decode_step(rp, jnp.asarray(nxt[i]), rcache, jnp.int32(14 + i), rc)
        with _RouterMargins(monkeypatch) as step:
            pl, pcache = T.decode_step(pp, torch.from_numpy(nxt[i]), pcache, 14 + i, pc)
        margins.least = min(margins.least, step.least)
        assert tuple(pl.shape) == (2, 1, rc.vocab)
        np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL[dtype], rtol=0)
    margins.check(pc)
    _close_trees(pcache, rcache, TOL[dtype], "decoded cache")
    if pc.hybrid_pattern:  # position 16 went to slot 0 of the 16-slot ring
        assert int(pcache["tail"][0]["h"].shape[-1]) == pc.d_model
        assert int(pcache["blocks"]["p2_attn"]["kpos"][0, 0]) == 16
    empty = T.init_cache(pc, 3, 20, device="cpu")
    got_empty = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                 for p, t in tree_leaves_with_path(empty)}
    assert got_empty == {p: (tuple(x.shape), str(x.dtype))
                         for p, x in _ref_leaves(RT.init_cache(rc, 3, 20)).items()}


def test_reference_bf16_router_flips_against_itself(monkeypatch):
    """The evidence for ROUTER_MARGIN: on granite's bf16 smoke model, a token
    draw whose least router margin lies between 1e-4 and ROUTER_MARGIN
    makes the reference's jitted forward and its eager (disable_jit)
    forward, the same function, differ by more than the bf16 tolerance;
    the port lands within that distance of the jitted one, not within the
    tolerance."""
    rc, pc, rp, pp = _models("granite_moe_1b_a400m", "bfloat16")
    tok = _tokens((2, 12), rc.vocab, NEAR_TIE_SEED)
    jitted = _np(jax.jit(lambda p, t: RT.forward(p, t, rc, remat=False, kv_block=0)[0])(
        rp, jnp.asarray(tok)))
    with jax.disable_jit():
        eager = _np(RT.forward(rp, jnp.asarray(tok), rc, remat=False, kv_block=0)[0])
    with _RouterMargins(monkeypatch) as margins:
        got, _ = T.forward(pp, torch.from_numpy(tok), pc, kv_block=0)
    assert 1e-4 < margins.least < ROUTER_MARGIN, margins.least
    self_diff = float(np.abs(jitted - eager).max())
    assert self_diff > TOL["bfloat16"], self_diff
    assert float(np.abs(_np(got) - jitted).max()) < 2 * self_diff


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_active_params_full_width(arch):
    """count_active_params at the published widths, nothing allocated (the
    shapes and count_params are held with the dense family's in
    tests/test_torch_transformer.py)."""
    cfg, rcfg = configs.get_config(arch), ref_get_config(arch)
    assert T.count_active_params(cfg) == RT.count_active_params(rcfg)
    assert (T.count_active_params(cfg) < T.count_params(cfg)) == (cfg.moe is not None)


@pytest.mark.parametrize("arch,n_layers,d", [
    ("granite-moe-1b-a400m", 24, 1_384_963_072), ("mamba2-2.7b", 32, 1_544_194_048),
    ("recurrentgemma-2b", 5, 1_751_221_760)])
def test_chip_cells_parameter_counts(arch, n_layers, d):
    """The full-width cells the chip serves: D at the cut depth."""
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=n_layers)
    assert T.count_params(cfg) == d == RT.count_params(
        dataclasses.replace(ref_get_config(arch), n_layers=n_layers))


@pytest.mark.parametrize("arch,dtype,n_layers", CASES, ids=IDS)
def test_ravel_order_and_convert_round_trip(arch, dtype, n_layers):
    """The port's ravel of converted parameters (blocks < embed < final_norm
    < lm_head < tail; p0_rec < p1_rec < p2_attn; A_log / D_skip before the
    lowercase names) is bitwise the reference's ravel_pytree, f32 leaves of
    bf16 models included, and to_reference gives the arrays back."""
    rc, pc, rp, pp = _models(arch, dtype, n_layers)
    want = jax.flatten_util.ravel_pytree(rp)[0]
    got = ravel(pp)[0]
    assert got.numel() == want.size
    np.testing.assert_array_equal(_np(got), _np(want))
    back = convert.transformer_to_reference(pp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)), back,
        jax.tree.map(np.asarray, rp))
    if arch == "mamba2_2_7b":
        assert list(pp["blocks"]["p0_ssm"])[:2] == ["A_log", "D_skip"]
        assert pp["blocks"]["p0_ssm"]["A_log"].dtype == torch.float32
    if arch == "recurrentgemma_2b":
        assert list(pp) == ["blocks", "embed", "final_norm", "lm_head", "tail"]
        assert list(pp["blocks"]) == ["p0_rec", "p1_rec", "p2_attn"]
        bad = jax.tree.map(np.asarray, rp)
        bad["tail"] = bad["tail"][:1]
        with pytest.raises(KeyError, match="tail"):
            convert.transformer_from_reference(pc, bad, device="cpu")
