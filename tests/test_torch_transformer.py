"""The port's dense transformer (repro_torch.models.{layers, attention,
transformer}, models.convert) against the reference's
(repro.models.transformer), on the CPU.

The reference's parameters (its own init, as numpy) are carried over with
``convert.transformer_from_reference``; tokens come from numpy.  Tolerances
(absolute, on logits of magnitude < 1):
- float32: 1e-5 (observed ~2e-7: the packages sum in different orders);
- bfloat16: 1e-2 (observed 3.9e-3, one bf16 ulp at 0.5; every matmul
  rounds its output to bf16 in both packages, not always the same way).
Cache positions (``kpos``) are integers and equal exactly.
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
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.models import attention as A
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import ravel

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TINY = dict(name="serve-test", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=128)


def _cfgs(arch="llama3_2_3b", **kw):
    """The same tiny configuration in both packages (tests/test_serve.py's
    _tiny_cfg, with overrides)."""
    over = dict(TINY, **kw)
    return (dataclasses.replace(ref_get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def _models(arch="llama3_2_3b", seed=0, **kw):
    rc, pc = _cfgs(arch, **kw)
    rp = RT.init_params(rc, jax.random.PRNGKey(seed))
    pp = convert.transformer_from_reference(pc, jax.tree.map(np.asarray, rp), device="cpu")
    return rc, pc, rp, pp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


CASES = [("float32", 1), ("float32", 2), ("bfloat16", 2)]


@pytest.mark.parametrize("dtype,n_layers", CASES)
def test_forward_and_loss_match_reference(dtype, n_layers):
    rc, pc, rp, pp = _models(dtype=dtype, n_layers=n_layers)
    tok = _tokens((2, 12), rc.vocab, 1)
    lab = _tokens((2, 12), rc.vocab, 2)
    want, _ = RT.forward(rp, jnp.asarray(tok), rc, remat=False, kv_block=0)
    got, aux = T.forward(pp, torch.from_numpy(tok), pc, kv_block=0)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (2, 12, rc.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)
    assert float(aux) == 0.0
    batch = {"tokens": tok, "labels": lab}
    want_loss = RT.loss_fn(rp, {k: jnp.asarray(v) for k, v in batch.items()}, rc,
                           remat=False, kv_block=0)
    got_loss = T.loss_fn(pp, {k: torch.from_numpy(v) for k, v in batch.items()}, pc, kv_block=0)
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype,n_layers", CASES)
def test_prefill_and_decode_chain_match_reference(dtype, n_layers):
    """prefill at cache_len = prompt + 6, then a 6-step decode_step chain on
    numpy tokens: logits at every step, the cache's shapes, keys, values and
    kpos after the chain."""
    rc, pc, rp, pp = _models(dtype=dtype, n_layers=n_layers)
    tok = _tokens((2, 10), rc.vocab, 3)
    nxt = _tokens((6, 2, 1), rc.vocab, 4)
    rl, rcache = RT.prefill(rp, jnp.asarray(tok), rc, kv_block=0, cache_len=16)
    pl, pcache = T.prefill(pp, torch.from_numpy(tok), pc, kv_block=0, cache_len=16)
    np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL[dtype], rtol=0)
    for i in range(6):
        rl, rcache = RT.decode_step(rp, jnp.asarray(nxt[i]), rcache, jnp.int32(10 + i), rc)
        pl, pcache = T.decode_step(pp, torch.from_numpy(nxt[i]), pcache, 10 + i, pc)
        assert tuple(pl.shape) == (2, 1, rc.vocab)
        np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL[dtype], rtol=0)
    rblk, pblk = rcache["blocks"]["p0_attn"], pcache["blocks"]["p0_attn"]
    assert set(pblk) == set(rblk) == {"k", "v", "kpos"}
    assert tuple(pblk["k"].shape) == np.shape(rblk["k"]) == (n_layers, 2, 16, 2, rc.hd)
    assert tuple(pblk["kpos"].shape) == np.shape(rblk["kpos"]) == (n_layers, 16)
    np.testing.assert_array_equal(pblk["kpos"].numpy(), np.asarray(rblk["kpos"]))
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(pblk[k]), _np(rblk[k]), atol=TOL[dtype], rtol=0)
    # init_cache: the reference's shapes, every slot masked
    empty, ref_empty = T.init_cache(pc, 3, 20, device="cpu"), RT.init_cache(rc, 3, 20)
    for k in ("k", "v", "kpos"):
        assert (tuple(empty["blocks"]["p0_attn"][k].shape)
                == np.shape(ref_empty["blocks"]["p0_attn"][k]))
    assert bool((empty["blocks"]["p0_attn"]["kpos"] == -1).all())


def test_sliding_window_ring_cache_and_qk_norm_match_reference():
    """h2o-danube's native sliding window (8 < prompt 12: the ring-buffer
    prefill and decode) and qwen3's qk-norm, in float32."""
    for arch, kw in (("h2o_danube_1_8b", dict(sliding_window=8)), ("qwen3_14b", {})):
        rc, pc, rp, pp = _models(arch, dtype="float32", n_layers=2, **kw)
        tok = _tokens((1, 12), rc.vocab, 5)
        nxt = _tokens((5, 1, 1), rc.vocab, 6)
        rl, rcache = RT.prefill(rp, jnp.asarray(tok), rc, kv_block=0, cache_len=17)
        pl, pcache = T.prefill(pp, torch.from_numpy(tok), pc, kv_block=0, cache_len=17)
        np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL["float32"], rtol=0)
        np.testing.assert_array_equal(pcache["blocks"]["p0_attn"]["kpos"].numpy(),
                                      np.asarray(rcache["blocks"]["p0_attn"]["kpos"]))
        for i in range(5):
            rl, rcache = RT.decode_step(rp, jnp.asarray(nxt[i]), rcache, jnp.int32(12 + i), rc)
            pl, pcache = T.decode_step(pp, torch.from_numpy(nxt[i]), pcache, 12 + i, pc)
            np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL["float32"], rtol=0)
        np.testing.assert_array_equal(pcache["blocks"]["p0_attn"]["kpos"].numpy(),
                                      np.asarray(rcache["blocks"]["p0_attn"]["kpos"]))


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0), (False, 0, 0),
                                                    (True, 5, 0), (True, 0, 3)])
def test_attention_functions_match_reference(causal, window, q_offset):
    """plain, chunked (ragged last block) and the dispatch, and
    decode_attention, in float32 on numpy inputs."""
    rs = np.random.default_rng(7)
    q = rs.standard_normal((2, 9, 2, 3, 8)).astype(np.float32)
    k = rs.standard_normal((2, 11, 2, 8)).astype(np.float32)
    v = rs.standard_normal((2, 11, 2, 8)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = RA.plain_attention(jq, jk, jv, causal, window, q_offset)
    np.testing.assert_allclose(_np(A.plain_attention(tq, tk, tv, causal, window, q_offset)),
                               _np(want), atol=1e-5, rtol=0)
    got = A.chunked_attention(tq, tk, tv, causal, window, q_offset, kv_block=4)
    np.testing.assert_allclose(_np(got), _np(RA.chunked_attention(
        jq, jk, jv, causal, window, q_offset, kv_block=4)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)
    for kv_block in (0, 4, 16):
        np.testing.assert_allclose(
            _np(A.attention(tq, tk, tv, causal, window, q_offset, kv_block)),
            _np(RA.attention(jq, jk, jv, causal, window, q_offset, kv_block)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        _np(A.decode_attention(tq[:, :1], tk, tv, 7, window, pos_offset=q_offset)),
        _np(RA.decode_attention(jq[:, :1], jk, jv, jnp.int32(7), window, q_offset)),
        atol=1e-5, rtol=0)
    assert A.NEG_INF == RA.NEG_INF


def test_layers_match_reference():
    rs = np.random.default_rng(8)
    x = rs.standard_normal((3, 5, 16)).astype(np.float32)
    s = rs.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(_np(L.rms_norm(torch.from_numpy(x), torch.from_numpy(s))),
                               _np(RL.rms_norm(jnp.asarray(x), jnp.asarray(s))), atol=1e-5)
    b = rs.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.layer_norm(*map(torch.from_numpy, (x, s, b)))),
        _np(RL.layer_norm(*map(jnp.asarray, (x, s, b)))), atol=1e-5)
    xr = rs.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5)[None, :] + 100
    np.testing.assert_allclose(_np(L.rope(torch.from_numpy(xr), torch.from_numpy(pos), 5e5)),
                               _np(RL.rope(jnp.asarray(xr), jnp.asarray(pos), 5e5)), atol=1e-5)
    np.testing.assert_allclose(_np(L.sinusoidal_positions(6, 8)),
                               _np(RL.sinusoidal_positions(6, 8)), atol=1e-6)
    w = [rs.standard_normal(sh).astype(np.float32) * 0.2 for sh in ((16, 12), (16, 12), (12, 16))]
    np.testing.assert_allclose(_np(L.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w))),
                               _np(RL.swiglu(jnp.asarray(x), *map(jnp.asarray, w))), atol=1e-5)
    np.testing.assert_allclose(_np(L.geglu(torch.from_numpy(x), *map(torch.from_numpy, w))),
                               _np(RL.geglu(jnp.asarray(x), *map(jnp.asarray, w))), atol=1e-5)
    bi, bo = (rs.standard_normal((k,)).astype(np.float32) for k in (12, 16))
    args = (w[0], bi, w[2], bo)
    np.testing.assert_allclose(
        _np(L.gelu_mlp(torch.from_numpy(x), *map(torch.from_numpy, args))),
        _np(RL.gelu_mlp(jnp.asarray(x), *map(jnp.asarray, args))), atol=1e-5)
    logits = rs.standard_normal((4, 6, 10)).astype(np.float32)
    labels = rs.integers(0, 10, (4, 6))
    mask = (rs.random((4, 6)) < 0.5).astype(np.float32)
    for mk in (None, mask):
        got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                              None if mk is None else torch.from_numpy(mk))
        want = RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if mk is None else jnp.asarray(mk))
        np.testing.assert_allclose(float(got), float(want), atol=1e-5)


ARCHS = ("llama3.2-3b", "llama3-405b", "qwen3-14b", "h2o-danube-1.8b",
         "granite-moe-1b-a400m", "grok-1-314b", "mamba2-2.7b", "recurrentgemma-2b",
         "whisper-small", "internvl2-1b")


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_shapes_full_width(arch):
    """count_params and param_shapes at the published widths, nothing
    allocated, equal to the reference's eval_shape count and structure
    (the SSM's and RG-LRU's float32 leaves of bf16 models included; the
    encoder and cross-attention groups of whisper)."""
    cfg, rcfg = configs.get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert T.count_params(cfg) == RT.count_params(rcfg)
    ref_shapes = RT.param_shapes(rcfg)
    got = T.param_shapes(cfg)
    flat_ref = {jax.tree_util.keystr(p): (tuple(l.shape), str(l.dtype))
                for p, l in jax.tree_util.tree_leaves_with_path(ref_shapes)}
    flat_got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + f"['{k}']")
        elif isinstance(t, list):  # the hybrid pattern's unrolled tail
            for i, x in enumerate(t):
                walk(x, path + f"[{i}]")
        else:
            flat_got[path] = (tuple(t[0]), str(t[1]).removeprefix("torch."))

    walk(got, "")
    assert flat_got == flat_ref
    assert list(flat_got) == sorted(flat_got)  # sorted keys: ravel_pytree's order


def test_llama3_2_3b_width_at_8_layers():
    """The chip cell's parameter count: D = 2*128256*3072 + 3072 + 8*100,669,440."""
    cfg = dataclasses.replace(configs.get_config("llama3.2-3b"), n_layers=8)
    assert T.count_params(cfg) == 1_593_363_456 == RT.count_params(
        dataclasses.replace(ref_get_config("llama3.2-3b"), n_layers=8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ravel_order_and_convert_round_trip(dtype):
    """The port's ravel of converted parameters is bitwise the reference's
    ravel_pytree, and to_reference gives the reference's arrays back."""
    rc, pc, rp, pp = _models(dtype=dtype, n_layers=2)
    want = jax.flatten_util.ravel_pytree(rp)[0]
    got = ravel(pp)[0]
    assert got.dtype == getattr(torch, dtype) and got.numel() == want.size
    np.testing.assert_array_equal(_np(got), _np(want))
    back = convert.transformer_to_reference(pp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)), back,
        jax.tree.map(np.asarray, rp))
    bad = jax.tree.map(np.asarray, rp)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        convert.transformer_from_reference(pc, bad, device="cpu")
    del bad["embed"]
    with pytest.raises(KeyError):
        convert.transformer_from_reference(pc, bad, device="cpu")


def test_init_params_structure_and_determinism():
    """The port's own init: the reference's structure, dtypes and scales
    (norm scales zero, N(0, 0.02^2) weights, wo/wd scaled by
    1/sqrt(2 n_layers)), one result per (seed, device)."""
    _, pc = _cfgs(n_layers=2, dtype="float32", d_model=128, d_ff=256)
    a = T.init_params(pc, seed=3, device="cpu")
    b = T.init_params(pc, seed=3, device="cpu")
    c = T.init_params(pc, seed=4, device="cpu")
    np.testing.assert_array_equal(ravel(a)[0].numpy(), ravel(b)[0].numpy())
    assert not np.array_equal(ravel(a)[0].numpy(), ravel(c)[0].numpy())
    blk = a["blocks"]["p0_attn"]
    assert float(blk["ln1"].abs().max()) == 0.0 and float(a["final_norm"].abs().max()) == 0.0
    assert abs(float(a["embed"].std()) - 0.02) < 0.002
    assert abs(float(blk["wo"].std()) - 0.02 / 2.0) < 0.002
    assert list(a) == sorted(a) and list(blk) == sorted(blk)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            T.init_params(pc, seed=0)
