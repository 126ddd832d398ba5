"""Parity of the port's attack engine with the JAX reference (CPU).

Deterministic payloads are bitwise the reference's, on the statistics
path (same honest mean/variance in) and on the gathered-rows path (the
port's honest statistics included).  Randomized payloads cannot share
the reference's threefry bits: they are held by injecting the noise the
port's generator draws, and in distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import attacks as jattacks
from repro.attacks import engine as jengine
from repro.core import attacks as jcore
from repro_torch import attacks
from repro_torch.attacks import engine
from repro_torch.core import attacks as core

torch.set_num_threads(2)

DETERMINISTIC = ["sign_flip", "large_value", "alie", "alie_fitted", "mean_shift", "ipm",
                 "mimic", "max_damage_tm", "local_sign_flip", "zero", "stale"]


def _rows(m=8, shape=(5, 3), seed=0):
    return np.random.default_rng(seed).standard_normal((m,) + shape).astype(np.float32)


def _bitequal(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(g.view(np.int32), w.view(np.int32))


def test_registry_matches_reference():
    assert attacks.registered() == jattacks.registered()
    for name in jattacks.registered():
        a, j = attacks.get_attack(name), jattacks.get_attack(name)
        for field in ("access", "strength", "adaptive", "randomized", "needs_variance",
                      "reads_own", "arrival", "summary"):
            assert getattr(a, field) == getattr(j, field), (name, field)
    assert attacks.get_attack("inner_product").name == "ipm"
    assert core.NEEDS_VARIANCE == jcore.NEEDS_VARIANCE


@pytest.mark.parametrize("alpha,m", [(0.0, 8), (0.1, 10), (0.25, 8), (0.5, 7), (1.0, 5)])
def test_num_byzantine_and_mask(alpha, m):
    assert engine.num_byzantine(alpha, m) == jengine.num_byzantine(alpha, m)
    assert np.array_equal(engine.byzantine_mask(alpha, m, device="cpu").numpy(),
                          np.asarray(jengine.byzantine_mask(alpha, m)))
    q = engine.num_byzantine(torch.tensor(alpha), m)
    assert int(q) == int(jengine.num_byzantine(jnp.float32(alpha), m))


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_deterministic_payloads_bitwise_on_rows(name):
    rows = _rows(seed=DETERMINISTIC.index(name))
    prev = rows[-1] * 0.5
    cfg = core.AttackConfig(name, alpha=0.25, scale=7.0)
    jcfg = jcore.AttackConfig(name, alpha=0.25, scale=7.0)
    mask = core.AttackConfig(name, alpha=0.25).byzantine_mask(8, device="cpu")
    got = core.apply_gradient_attack(cfg, torch.from_numpy(rows), mask,
                                     prev_agg=torch.from_numpy(prev))
    want = jcore.apply_gradient_attack(jcfg, jnp.asarray(rows), jnp.asarray(mask.numpy()),
                                       prev_agg=jnp.asarray(prev))
    _bitequal(got.numpy(), want)


@pytest.mark.parametrize("name", ["sign_flip", "large_value", "alie", "alie_fitted",
                                  "mean_shift", "ipm", "local_sign_flip", "zero", "stale"])
def test_deterministic_payloads_bitwise_on_stats(name):
    rng = np.random.default_rng(1)
    mean, var, own = (rng.standard_normal(12).astype(np.float32) for _ in range(3))
    var = np.abs(var)
    hist = rng.standard_normal((3, 12)).astype(np.float32)
    cfg = core.AttackConfig(name, alpha=0.3, scale=4.0, shift=1.5)
    jcfg = jcore.AttackConfig(name, alpha=0.3, scale=4.0, shift=1.5)
    got = core.byzantine_payload(cfg, torch.from_numpy(mean), torch.from_numpy(var), m=10,
                                 own=torch.from_numpy(own), agg_history=torch.from_numpy(hist),
                                 staleness=2)
    want = jcore.byzantine_payload(jcfg, jnp.asarray(mean), jnp.asarray(var), m=10,
                                   own=jnp.asarray(own), agg_history=jnp.asarray(hist),
                                   staleness=2)
    _bitequal(np.broadcast_to(got.numpy(), np.shape(want)), want)


def test_honest_statistics_bitwise():
    rows = _rows(m=10, seed=3)
    mask = engine.byzantine_mask(0.3, 10, device="cpu")
    got = engine.honest_statistics(torch.from_numpy(rows), mask)
    want = jengine.honest_statistics(jnp.asarray(rows), jnp.asarray(mask.numpy()))
    for g, w in zip(got, want):
        _bitequal(g.numpy(), w)


def test_gauss_is_strength_times_injected_noise():
    rows = torch.from_numpy(_rows(m=6, shape=(2000,)))
    mask = engine.byzantine_mask(0.5, 6, device="cpu")
    out = engine.apply_to_rows("gauss", rows, mask, strength=3.0,
                               generator=torch.Generator().manual_seed(11))
    noise = torch.randn(rows.shape, generator=torch.Generator().manual_seed(11))
    # the reference formula, strength * N(0, I), on the same noise
    assert torch.equal(out[:3], 3.0 * noise[:3])
    assert torch.equal(out[3:], rows[3:])
    assert abs(float(out[:3].std()) - 3.0) < 0.1 and abs(float(out[:3].mean())) < 0.1


def test_label_attacks():
    y = torch.arange(10).repeat(50)
    want = np.asarray(jcore.label_flip(jnp.asarray(y.numpy())))
    assert np.array_equal(core.label_flip(y).numpy(), want)
    r1 = core.random_label(y, torch.Generator().manual_seed(3))
    r2 = core.random_label(y, torch.Generator().manual_seed(3))
    assert torch.equal(r1, r2) and r1.dtype == y.dtype
    counts = torch.bincount(r1, minlength=10)
    assert int(counts.min()) > 20 and int(r1.max()) == 9
    batch = {"x": torch.zeros(500), "y": y}
    out = core.apply_data_attack(core.AttackConfig("label_flip", alpha=0.2), batch, True)
    assert torch.equal(out["y"], 9 - y)
    out = core.apply_data_attack(core.AttackConfig("label_flip", alpha=0.2), batch, False)
    assert torch.equal(out["y"], y)


def test_access_filtering_and_statistics_path_guards():
    rows = torch.from_numpy(_rows())
    for name in attacks.registered():
        atk = attacks.get_attack(name)
        ctx = engine.build_context(atk, m=8, alpha=0.25, rows=rows, own=rows,
                                   honest_mean=rows[0], honest_var=rows[1] ** 2,
                                   mask=torch.zeros(8, dtype=torch.bool))
        jctx = jengine.build_context(jattacks.get_attack(name), m=8, alpha=0.25,
                                     rows=1, own=1, honest_mean=1, honest_var=1, mask=1)
        for field in ("own", "honest_mean", "honest_var", "rows", "mask"):
            assert (getattr(ctx, field) is None) == (getattr(jctx, field) is None), (name, field)
    with pytest.raises(ValueError, match="omniscient"):
        engine.payload_from_stats("mimic", rows[0], None, m=8, alpha=0.2)
    with pytest.raises(ValueError, match="own"):
        engine.payload_from_stats("local_sign_flip", rows[0], None, m=8, alpha=0.2)
    assert engine.apply_to_rows("label_flip", rows, torch.ones(8, dtype=torch.bool)) is rows


def test_feedback_attacks_registered():
    scores = torch.linspace(-1, 1, 9)
    flip = attacks.get_attack("feedback_flip").corrupt_feedback(scores, None, 1.0)
    want = jattacks.get_attack("feedback_flip").corrupt_feedback(
        jnp.asarray(scores.numpy()), jax.random.PRNGKey(0), 1.0)
    _bitequal(flip.numpy(), want)
    alie = attacks.get_attack("feedback_alie").corrupt_feedback(scores, None, 1.5)
    want = jattacks.get_attack("feedback_alie").corrupt_feedback(
        jnp.asarray(scores.numpy()), jax.random.PRNGKey(0), 1.5)
    np.testing.assert_allclose(alie.numpy(), np.asarray(want), rtol=1e-6)
