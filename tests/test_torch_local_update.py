"""Robust local-update GD (``rounds.local_update``) on the port: the
τ-interpolation's endpoints within the port, and trajectories against the
JAX reference on the same numpy data (CPU).

Tolerances: τ = 1 is bit for bit the port's ``robust_gd`` (the same vmap
layout, attack generators and aggregate carry), as the reference pins for
itself.  One round at a large τ equals the one-round estimator within
1e-5 relative / 1e-6 absolute (the reference's tolerance: the same local
steps, aggregated as models or as accumulated gradients).  Against the
reference, gradient-dependent trajectories are held to 1e-5 absolute on
||w - w*|| per round (float32 reduction orders in the gradients), and a
greedy schedule picks the same attacks round by round.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attacks import AttackConfig as JAttackConfig
from repro.core.robust_gd import linreg_loss as j_linreg_loss
from repro.fed.rounds import AttackMixture as JAttackMixture
from repro.rounds import (LocalUpdateConfig as JLocalUpdateConfig,
                          local_update_gd as j_local_update_gd,
                          run_local_update_rounds as j_run_local_update_rounds)
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.robust_gd import RobustGDConfig, linreg_loss, robust_gd
from repro_torch.fed.rounds import AttackMixture
from repro_torch.rounds import (LocalUpdateConfig, OneRoundConfig, local_update_gd,
                                make_gd_local_solver, one_round, run_local_update_rounds)

torch.set_num_threads(2)


def _linreg(n, m, d=8, sigma=0.5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n, d)).astype(np.float32)
    w_star = (rng.standard_normal(d) / np.sqrt(d)).astype(np.float32)
    y = (x @ w_star + sigma * rng.standard_normal((m, n))).astype(np.float32)
    return x, y, w_star


def _setup(seed=0):
    x, y, w_star = _linreg(64, 16, seed=seed)
    ws = torch.from_numpy(w_star)
    traj = lambda w: torch.linalg.vector_norm(w - ws)  # noqa: E731
    return (torch.from_numpy(x), torch.from_numpy(y)), torch.zeros(8), traj, (x, y, w_star)


@pytest.mark.parametrize("method", ["median", "trimmed_mean"])
@pytest.mark.parametrize("atk", [None, AttackConfig("alie", alpha=0.25, shift=1.5),
                                 AttackConfig("gauss", alpha=0.25),
                                 AttackConfig("stale", alpha=0.25)],
                         ids=["clean", "alie", "gauss", "stale"])
def test_tau1_bit_for_bit_robust_gd(atk, method):
    shards, w0, traj, _ = _setup()
    wg, mg = robust_gd(linreg_loss, w0, shards,
                       RobustGDConfig(method=method, beta=0.3, step_size=0.1, num_iters=25),
                       atk, traj)
    wl, ml = local_update_gd(linreg_loss, w0, shards,
                             LocalUpdateConfig(method=method, beta=0.3, step_size=0.1, tau=1,
                                               num_rounds=25), atk, traj)
    assert torch.equal(wg, wl) and torch.equal(mg, ml)


def test_one_round_of_large_tau_is_the_one_round_estimator():
    shards, w0, _, _ = _setup()
    cfg = LocalUpdateConfig(method="median", step_size=0.05, tau=60, num_rounds=1)
    wl, _ = local_update_gd(linreg_loss, w0, shards, cfg)
    solver = make_gd_local_solver(linreg_loss, w0, steps=60, lr=0.05)
    wo = one_round(solver, shards, OneRoundConfig("median"))
    torch.testing.assert_close(wl, wo, rtol=1e-5, atol=1e-6)


def test_larger_tau_fewer_rounds_same_error():
    shards, w0, traj, _ = _setup()
    atk = AttackConfig("alie", alpha=0.1, shift=1.5)
    base = LocalUpdateConfig(method="median", step_size=0.05, tau=1, num_rounds=48)
    few = LocalUpdateConfig(method="median", step_size=0.05, tau=8, num_rounds=6)
    _, errs1 = local_update_gd(linreg_loss, w0, shards, base, atk, traj)
    _, errs8 = local_update_gd(linreg_loss, w0, shards, few, atk, traj)
    assert float(errs8[-1]) <= 1.15 * float(errs1[-1])


@pytest.mark.parametrize("method,atk_name", [("median", "alie"), ("trimmed_mean", "sign_flip"),
                                             ("mean", "zero")])
def test_trajectory_matches_reference(method, atk_name):
    shards, w0, traj, (x, y, w_star) = _setup(seed=1)
    kw = dict(method=method, beta=0.3, step_size=0.1, tau=4, num_rounds=10)
    akw = dict(alpha=0.25, shift=1.5, scale=5.0)
    _, got = local_update_gd(linreg_loss, w0, shards, LocalUpdateConfig(**kw),
                             AttackConfig(atk_name, **akw), traj)
    _, want = j_local_update_gd(j_linreg_loss, jnp.zeros(8), (jnp.asarray(x), jnp.asarray(y)),
                                JLocalUpdateConfig(**kw), JAttackConfig(atk_name, **akw),
                                lambda w: jnp.linalg.norm(w - w_star))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_tau_must_be_positive_and_bare_names_refused():
    shards, w0, _, _ = _setup()
    with pytest.raises(ValueError, match="tau"):
        local_update_gd(linreg_loss, w0, shards, LocalUpdateConfig(tau=0, num_rounds=1))
    with pytest.raises(ValueError, match="Byzantine fraction"):
        local_update_gd(linreg_loss, w0, shards, LocalUpdateConfig(num_rounds=1), attack="alie")


def test_greedy_schedule_matches_reference():
    shards, w0, traj, (x, y, w_star) = _setup()
    cfg = dict(method="median", step_size=0.1, tau=4, num_rounds=8)
    _, hist = run_local_update_rounds(
        linreg_loss, w0, shards, LocalUpdateConfig(**cfg),
        AttackMixture((AttackConfig("zero", alpha=0.25),
                       AttackConfig("sign_flip", alpha=0.25, scale=20.0)), schedule="greedy"),
        traj)
    _, jhist = j_run_local_update_rounds(
        j_linreg_loss, jnp.zeros(8), (jnp.asarray(x), jnp.asarray(y)), JLocalUpdateConfig(**cfg),
        JAttackMixture((JAttackConfig("zero", alpha=0.25),
                        JAttackConfig("sign_flip", alpha=0.25, scale=20.0)), schedule="greedy"),
        lambda w: jnp.linalg.norm(w - w_star))
    names = [h["attack"] for h in hist]
    assert names == [h["attack"] for h in jhist]
    assert names[:2] == ["zero", "sign_flip"] and all(n == "sign_flip" for n in names[2:])
    assert all(h["tau"] == 4 for h in hist)
    for h, j in zip(hist, jhist):
        assert h["round"] == j["round"]
        assert abs(h["metric"] - j["metric"]) <= 1e-5
        assert abs(h["delta_norm"] - j["delta_norm"]) <= 1e-4 * max(1.0, j["delta_norm"])


def test_cycle_schedule_adaptive_attack_and_clean_convergence():
    shards, w0, traj, _ = _setup()
    mix = AttackMixture((AttackConfig("zero", alpha=0.25), AttackConfig("gauss", alpha=0.25)))
    w, hist = run_local_update_rounds(
        linreg_loss, w0, shards,
        LocalUpdateConfig(method="median", step_size=0.1, tau=2, num_rounds=4), mix, traj)
    assert [h["attack"] for h in hist] == ["zero", "gauss", "zero", "gauss"]
    assert hist[-1]["metric"] == pytest.approx(float(traj(w)))
    cfg = LocalUpdateConfig(method="mean", step_size=0.1, tau=2, num_rounds=5)
    runs = {name: run_local_update_rounds(
        linreg_loss, w0, shards, cfg,
        AttackMixture((AttackConfig(name, alpha=0.25),), schedule="fixed"), traj)[1]
        for name in ("stale", "zero")}
    assert runs["stale"][0]["metric"] == pytest.approx(runs["zero"][0]["metric"])
    assert abs(runs["stale"][-1]["metric"] - runs["zero"][-1]["metric"]) > 1e-5
    _, clean = run_local_update_rounds(
        linreg_loss, w0, shards,
        LocalUpdateConfig(method="median", step_size=0.1, tau=4, num_rounds=12), None, traj)
    assert clean[-1]["metric"] < 0.25 * clean[0]["metric"]


@pytest.mark.parametrize("comp", ["int8", "topk", "count_sketch"])
def test_compressed_rounds_converge_and_resume_bit_for_bit(comp, tmp_path):
    shards, w0, traj, _ = _setup()
    atk = AttackConfig("sign_flip", alpha=0.1, scale=10.0)
    cfg = LocalUpdateConfig(method="median", step_size=0.1, tau=2, num_rounds=8,
                            compression=comp)
    w, errs = local_update_gd(linreg_loss, w0, shards, cfg, atk, traj)
    assert float(errs[-1]) < float(errs[0])  # tests/test_compression.py's gate
    plain, _ = local_update_gd(linreg_loss, w0, shards,
                               LocalUpdateConfig(method="median", step_size=0.1, tau=2,
                                                 num_rounds=8), atk, traj)
    assert not torch.equal(w, plain)
    d = str(tmp_path / comp)
    local_update_gd(linreg_loss, w0, shards, LocalUpdateConfig(
        **{**cfg.__dict__, "num_rounds": 4}), atk, traj, ckpt_every=2, ckpt_dir=d)
    w_res, _ = local_update_gd(linreg_loss, w0, shards, cfg, atk, traj, ckpt_dir=d,
                               resume=True)
    assert torch.equal(w_res, w)
