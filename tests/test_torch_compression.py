"""The port's payload codecs (``rounds.compression``) against the JAX
reference, and their wiring into the federated rounds (CPU).

Parity: each codec is held bitwise to the reference on the same input,
with the reference's random draw injected (``draw=``): the int8 dither
``u = jax.random.uniform(key, ...)`` and the count sketch's rotated hash
``(h, s)`` from the reference's split key.  The fixed public count-sketch
hash is numpy ``RandomState(1729)`` in both, so it is bitwise without
injection.  Top-k and the sketch decode are deterministic and bitwise.
What a torch generator draws is held in distribution (unbiasedness), as
the reference's own tests hold it.  Within the port: clean federated
trajectories are bitwise invariant to the streaming chunk size for every
codec, and compressed rounds converge under attack (the reference's gate,
``hist[-1]["err"] < hist[0]["err"]``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rounds import compression as JC
from repro_torch.core.attacks import AttackConfig
from repro_torch.fed.population import ClientPopulation, PopulationConfig
from repro_torch.fed.rounds import AttackMixture, RoundConfig, run_rounds
from repro_torch.rounds import compression as C

torch.set_num_threads(2)

ALL = ("none", "int8", "topk", "count_sketch")


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _int8_draw(key, d):
    return torch.from_numpy(np.array(jax.random.uniform(key, C.int8_draw_shape(d))))


def _sketch_draw(key, d):
    """The reference's per-round (h, s) from ``key`` (rounds/compression.py
    ``_sketch_encode``)."""
    kh, ks = jax.random.split(key)
    w = C._sketch_w(d, 0.5)
    h = np.array(jax.random.randint(kh, (d,), 0, w))
    s = np.array(jax.random.bernoulli(ks, 0.5, (d,)).astype(jnp.float32) * 2 - 1)
    return torch.from_numpy(h), torch.from_numpy(s)


def _vec(d, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(d) * scale).astype(np.float32)


# ------------------------------------------------------------------ registry


def test_registry_matches_reference():
    assert C.registered_compressions() == JC.registered_compressions() == ALL
    for name in ALL:
        a, j = C.get_compression(name), JC.get_compression(name)
        for f in ("bytes_formula", "rate_penalty", "breakdown_scale", "error_feedback",
                  "randomized", "shared_key", "unbiased", "knob", "summary"):
            assert getattr(a, f) == getattr(j, f), (name, f)
        for d in (1, 7, 50, 256, 257, 53370):
            for b in (2, 4):
                assert a.payload_bytes(d, b) == j.payload_bytes(d, b)
                assert a.ratio(d, b) == j.ratio(d, b)
    with pytest.raises(ValueError, match="count_sketch"):
        C.get_compression("zstd")


def test_spec_invariants_and_bytes_models():
    for name in ALL:
        s = C.get_compression(name)
        assert s.rate_penalty >= 1.0 and 0.0 < s.breakdown_scale <= 1.0
        assert not (s.randomized and s.shared_key)
        assert s.ratio(256) == 1.0 if name == "none" else s.ratio(256) < 1.0
    d = 256
    assert C.get_compression("none").payload_bytes(d) == d * 4
    assert C.get_compression("int8").payload_bytes(d) == d + 4
    assert C.get_compression("topk").payload_bytes(d) == (d // 4) * 8
    assert C.get_compression("count_sketch").payload_bytes(d) == (d // 2) * 4
    for name in ALL:
        assert C.breakdown_alpha(name, 0.5) == JC.breakdown_alpha(name, 0.5)


# ------------------------------------------------------------- codec parity


def test_none_short_circuits_to_the_same_object():
    x = torch.arange(8.0)
    assert C.roundtrip("none", x) is x
    rows = torch.ones(4, 8)
    out, res = C.compress_rows("none", rows)
    assert out is rows and res is None
    tree = {"a": torch.ones(3)}
    t, r = C.compress_tree("none", tree)
    assert t is tree and r is None
    assert C.init_residual("none", tree) == ()


@pytest.mark.parametrize("d", [1, 50, 64, 256, 600, 1000])
def test_int8_bitwise_with_the_reference_draw(d):
    x = _vec(d, d)
    if d >= 300:
        x[:256] *= 1000.0  # a huge chunk next to ordinary ones
        x[256:300] = 0.0  # part of a zero chunk
    key = jax.random.PRNGKey(d)
    want = JC.roundtrip("int8", jnp.asarray(x), key=key)
    got = C.roundtrip("int8", torch.from_numpy(x), draw=_int8_draw(key, d))
    assert _bits_equal(got.numpy(), want)


def test_int8_rows_bitwise_with_the_reference_draws():
    m, d = 5, 300
    rows = np.stack([_vec(d, i) for i in range(m)])
    key = jax.random.PRNGKey(3)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(m))
    want, _ = JC.compress_rows("int8", jnp.asarray(rows), keys=keys)
    draw = torch.stack([_int8_draw(k, d) for k in keys])
    got, res = C.compress_rows("int8", torch.from_numpy(rows), draw=draw)
    assert res is None and _bits_equal(got.numpy(), want)


def test_int8_per_chunk_scale_is_local():
    x = torch.cat([torch.full((256,), 1000.0), torch.full((256,), 1e-3)])
    out = C.roundtrip("int8", x, generator=torch.Generator().manual_seed(0))
    tail = out[256:]
    assert float((tail - 1e-3).abs().max()) < 1e-3 and float(tail.abs().max()) > 0.0


def test_int8_unbiased_and_generator_deterministic():
    x = torch.from_numpy(_vec(64, 0))
    a = C.roundtrip("int8", x, generator=torch.Generator().manual_seed(1))
    b = C.roundtrip("int8", x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    n = 3000
    rows = C.compress_rows("int8", x.expand(n, 64).contiguous(),
                           generator=torch.Generator().manual_seed(2))[0]
    scale = float(x.abs().max()) / 127.0
    err = float((rows.mean(0) - x).abs().max())
    assert err < 2.5 * scale / np.sqrt(n)  # the reference's gate
    with pytest.raises(ValueError, match="randomized"):
        C.compress_rows("int8", rows)


@pytest.mark.parametrize("d", [1, 7, 32, 50, 513])
def test_topk_bitwise_and_residual_matches_reference(d):
    m = 4
    rows = np.stack([_vec(d, 10 + i) for i in range(m)])
    res = np.stack([_vec(d, 20 + i, 0.5) for i in range(m)])
    want, want_res = JC.compress_rows("topk", jnp.asarray(rows), residual=jnp.asarray(res))
    got, got_res = C.compress_rows("topk", torch.from_numpy(rows),
                                   residual=torch.from_numpy(res))
    assert _bits_equal(got.numpy(), want) and _bits_equal(got_res.numpy(), want_res)
    assert _bits_equal(C.roundtrip("topk", torch.from_numpy(rows[0])).numpy(),
                       JC.roundtrip("topk", jnp.asarray(rows[0])))


def test_topk_keeps_a_quarter_and_conserves_with_residual():
    m, d = 4, 32
    rows = torch.from_numpy(np.stack([_vec(d, i) for i in range(m)]))
    res = C.init_residual("topk", rows)
    out, res2 = C.compress_rows("topk", rows, residual=res)
    assert int((out != 0).sum()) == m * (d // 4)
    assert torch.equal(out + res2, rows + res)  # exact conservation
    out3, res3 = C.compress_rows("topk", torch.zeros_like(rows), residual=res2)
    assert torch.equal(out3 + res3, res2)


@pytest.mark.parametrize("d", [1, 2, 64, 600])
def test_count_sketch_fixed_hash_bitwise(d):
    w = C._sketch_w(d, 0.5)
    h, s = C._sketch_hash(d, w)
    jh, js = JC._sketch_hash(d, w)
    assert np.array_equal(h, jh) and np.array_equal(s, js)
    assert h.dtype == jh.dtype and s.dtype == js.dtype
    x = _vec(d, d + 1)
    assert _bits_equal(C.roundtrip("count_sketch", torch.from_numpy(x)).numpy(),
                       JC.roundtrip("count_sketch", jnp.asarray(x)))


@pytest.mark.parametrize("d", [2, 64, 600])
def test_count_sketch_rotated_hash_bitwise_with_the_reference_draw(d):
    x = _vec(d, 7 * d)
    key = jax.random.PRNGKey(d)
    want = JC.roundtrip("count_sketch", jnp.asarray(x), key=key)
    got = C.roundtrip("count_sketch", torch.from_numpy(x), draw=_sketch_draw(key, d))
    assert _bits_equal(got.numpy(), want)
    rows = np.stack([x, -x, 2 * x])
    want_rows, _ = JC.compress_rows("count_sketch", jnp.asarray(rows), key=key)
    got_rows, _ = C.compress_rows("count_sketch", torch.from_numpy(rows),
                                  draw=_sketch_draw(key, d))
    assert _bits_equal(got_rows.numpy(), want_rows)


def test_count_sketch_linear_under_one_draw_and_unbiased_across_rounds():
    d = 64
    draw = C.sketch_draw(d, torch.Generator().manual_seed(3))
    a, b = torch.from_numpy(_vec(d, 4)), torch.from_numpy(_vec(d, 5))
    lhs = C.roundtrip("count_sketch", a + b, draw=draw)
    rhs = C.roundtrip("count_sketch", a, draw=draw) + C.roundtrip("count_sketch", b, draw=draw)
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(_vec(32, 6))
    gen = torch.Generator().manual_seed(7)
    mean = sum(C.roundtrip("count_sketch", x, generator=gen) for _ in range(4000)) / 4000
    assert float(torch.linalg.vector_norm(mean - x)) < 0.15 * float(torch.linalg.vector_norm(x))


@pytest.mark.parametrize("name", ["int8", "topk", "count_sketch"])
def test_roundtrip_preserves_shape_and_dtype(name):
    x = torch.from_numpy(_vec(50, 8))
    res = torch.zeros(50) if name == "topk" else None
    out, _ = C._apply_flat(C.get_compression(name), x, res, torch.Generator().manual_seed(9))
    assert out.shape == x.shape and out.dtype == x.dtype


def test_compress_tree_matches_reference_and_needs_key_and_residual():
    # keys in sorted order: the reference ravels dict leaves by sorted key,
    # the port in insertion order, and the flat residual follows that order
    tree = {"b": _vec(5, 2), "w": _vec(12, 1).reshape(3, 4)}
    flat_res = _vec(17, 3, 0.1)
    want, want_res = JC.compress_tree("topk", {k: jnp.asarray(v) for k, v in tree.items()},
                                      residual=jnp.asarray(flat_res))
    got, got_res = C.compress_tree("topk", {k: torch.from_numpy(v) for k, v in tree.items()},
                                   residual=torch.from_numpy(flat_res))
    assert _bits_equal(got_res.numpy(), want_res)
    for k in tree:
        assert got[k].shape == tree[k].shape and _bits_equal(got[k].numpy(), want[k])
    ones = {"w": torch.ones(6)}
    with pytest.raises(ValueError, match="randomized"):
        C.compress_tree("int8", ones)
    with pytest.raises(ValueError, match="error-feedback"):
        C.compress_tree("topk", ones)
    with pytest.raises(ValueError, match="error-feedback"):
        C.compress_rows("topk", torch.ones(2, 6))


def test_compress_tree_rows_keeps_structure_and_residual_tree():
    tree = {"a": torch.randn(4, 3, 2, generator=torch.Generator().manual_seed(0)),
            "b": (torch.randn(4, 5, generator=torch.Generator().manual_seed(1)),)}
    res = C.init_residual("topk", tree)
    out, new_res = C.compress_tree_rows("topk", tree, residual=res)
    assert out["a"].shape == (4, 3, 2) and out["b"][0].shape == (4, 5)
    for o, r, x in ((out["a"], new_res["a"], tree["a"]), (out["b"][0], new_res["b"][0],
                                                         tree["b"][0])):
        assert torch.equal(o + r, x)
    out, none_res = C.compress_tree_rows("int8", tree, generator=torch.Generator())
    assert none_res is None and out["b"][0].shape == (4, 5)


# -------------------------------------------- stateless surfaces reject EF


def test_validate_compression_context():
    with pytest.raises(ValueError, match="error-feedback"):
        C.validate_compression_context("topk", stateful=False, where="x")
    for name in ("none", "int8", "count_sketch"):
        C.validate_compression_context(name, stateful=False, where="x")
    C.validate_compression_context("topk", stateful=True, where="x")


def test_one_round_rejects_topk():
    from repro_torch.rounds import OneRoundConfig, one_round

    data = (torch.ones(4, 8, 2), torch.ones(4, 8))
    with pytest.raises(ValueError, match="error-feedback"):
        one_round(lambda batch: torch.zeros(2), data, OneRoundConfig(), compression="topk")


# ------------------------------------------------ federated rounds (within the port)


def _pop(alpha=0.0):
    return ClientPopulation(PopulationConfig(
        num_clients=96, samples_per_client=16, dim=8, alpha=alpha, noise=0.5, seed=0),
        device="cpu")


def _rcfg(comp, chunk, method="median"):
    return RoundConfig(num_rounds=3, cohort_size=32, chunk_clients=chunk, method=method,
                       lr=0.3, seed=0, compression=comp)


@pytest.mark.parametrize("method", ["median", "approx_median"])
@pytest.mark.parametrize("comp", ALL)
def test_clean_chunk_size_invariant(comp, method):
    pop = _pop()
    w8, h8 = run_rounds(pop, _rcfg(comp, 8, method))
    w32, h32 = run_rounds(pop, _rcfg(comp, 32, method))
    assert torch.equal(w8, w32)
    assert [h["err"] for h in h8] == [h["err"] for h in h32]


@pytest.mark.parametrize("comp", ["int8", "topk", "count_sketch"])
def test_compressed_rounds_converge_under_attack(comp):
    pop = _pop(alpha=0.1)
    mix = AttackMixture((AttackConfig("sign_flip", alpha=0.1),))
    rcfg = RoundConfig(num_rounds=8, cohort_size=32, chunk_clients=16, method="median",
                       lr=0.3, seed=0, compression=comp)
    _, hist = run_rounds(pop, rcfg, mix)
    assert hist[-1]["err"] < hist[0]["err"]


def test_compression_changes_the_trajectory_and_ef_needs_run_rounds():
    from repro_torch.fed.rounds import aggregate_cohort, init_comp_residual

    pop = _pop()
    w_none, _ = run_rounds(pop, _rcfg("none", 8))
    w_int8, _ = run_rounds(pop, _rcfg("int8", 8))
    assert not torch.equal(w_none, w_int8)
    assert init_comp_residual(pop, _rcfg("int8", 8)) is None
    assert init_comp_residual(pop, _rcfg("topk", 8)).shape == (96, 8)
    ids = pop.sample_cohort(0, 0, 16)
    with pytest.raises(ValueError, match="run_rounds"):
        aggregate_cohort(pop, torch.zeros(pop.cfg.dim), ids, _rcfg("topk", 8))


@pytest.mark.parametrize("comp", ALL)
def test_fed_cli_runs_every_codec(comp, capsys):
    from repro_torch.fed import run

    assert run.main(["--device", "cpu", "--clients", "400", "--cohort", "64", "--chunk", "16",
                     "--rounds", "2", "--dim", "8", "--alpha", "0.1",
                     "--compression", comp]) == 0
    out = capsys.readouterr().out
    assert f"compression={comp}" in out and "final iterate sha256" in out
