"""The port's distributed round programs (``repro_torch.rounds``:
``one_round_distributed``, ``make_local_update_round``) on the in-process
debug mesh, against the reference's shard_map programs on 8 forced CPU
devices.

The reference runs once, in one subprocess (its own tests' harness:
``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on
tests/test_rounds.py's linear-regression layout (d = 6, n = 32, m = 8),
drawn here with numpy and given to both packages.

Tolerances, stated where used:
- one round on the SAME rows (a solver that returns the reference's own
  per-worker solutions, carried as a third data leaf): gather and
  bucketed medians bitwise, the chunked sketch within one bin width of
  the reference's and of the exact median;
- one round with each package's own quadratic solver: 1e-5 absolute (the
  packages' linear solves round differently);
- local-update rounds, τ = 4 for 6 rounds: 1e-6 relative + 1e-7 absolute
  for gather and bucketed (the reference's own tolerance against its
  single-host loop), chunked within one bin width a round;
- the engine-driven loop and the bare loop: bitwise.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as core_dist
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.robust_gd import linreg_loss
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.rounds import (LocalUpdateConfig, OneRoundConfig, engine,
                                make_local_update_round, one_round_distributed,
                                quadratic_local_solver)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N, M = 6, 32, 8
STRATEGIES = ("gather", "bucketed", "chunked")
LU = dict(method="median", step_size=0.05, tau=4, num_rounds=6)
NBINS = 256  # aggregate_by_strategy's default sketch

REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.attacks import AttackConfig
from repro.core.robust_gd import linreg_loss
from repro.rounds import (LocalUpdateConfig, OneRoundConfig, make_local_update_round,
                          one_round_distributed, quadratic_local_solver)

data = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((8,), ("data",))
shards = (jnp.asarray(data["x"]), jnp.asarray(data["y"]))
out = {"solutions": np.asarray(jax.vmap(quadratic_local_solver)(shards))}
replay = shards + (jnp.asarray(out["solutions"]),)
atk = AttackConfig("sign_flip", alpha=0.25, scale=10.0)
for strat in ("gather", "bucketed", "chunked"):
    out[f"own_{strat}"] = np.asarray(one_round_distributed(
        quadratic_local_solver, shards, mesh, OneRoundConfig("median"), strategy=strat))
    out[f"replay_{strat}"] = np.asarray(one_round_distributed(
        lambda b: b[2], replay, mesh, OneRoundConfig("median"), strategy=strat))
    out[f"replay_atk_{strat}"] = np.asarray(one_round_distributed(
        lambda b: b[2], replay, mesh, OneRoundConfig("median"), strategy=strat, attack=atk))
    cfg = LocalUpdateConfig(method="median", step_size=0.05, tau=4, num_rounds=6)
    step = make_local_update_round(linreg_loss, cfg, mesh, strategy=strat)
    w = jnp.zeros((6,))
    for r in range(cfg.num_rounds):
        w = step(w, shards, jnp.int32(r))
        out[f"lu_{strat}_{r}"] = np.asarray(w)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _data(n=N):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n * M, D)).astype(np.float32)
    w_star = (rng.standard_normal(D) / np.sqrt(D)).astype(np.float32)
    y = (x @ w_star + 0.3 * rng.standard_normal(n * M)).astype(np.float32)
    return x.reshape(M, n, D), y.reshape(M, n), w_star


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(numpy data, the reference's outputs), one subprocess for the module."""
    d = tmp_path_factory.mktemp("ref_rounds_distributed")
    x, y, w_star = _data()
    np.savez(d / "in.npz", x=x, y=y)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return (x, y, w_star), dict(np.load(d / "out.npz"))


def _mesh():
    return make_debug_mesh(M, 1, device="cpu")


def _shards(x, y):
    return torch.from_numpy(x), torch.from_numpy(y)


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _bin_width(rows):
    return (rows.max(0) - rows.min(0)) / NBINS


@pytest.mark.parametrize("attacked", [False, True], ids=["clean", "sign_flip"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_round_distributed_on_the_reference_rows(ref, strategy, attacked):
    """The reference's own per-worker solutions aggregated by both packages:
    gather and bucketed bitwise, the sketch within one bin."""
    (x, y, _), out = ref
    sols = out["solutions"]
    atk = AttackConfig("sign_flip", alpha=0.25, scale=10.0) if attacked else None
    replay = _shards(x, y) + (torch.from_numpy(sols),)
    got = one_round_distributed(lambda b: b[2], replay, _mesh(), OneRoundConfig("median"),
                                strategy=strategy, attack=atk).numpy()
    want = out[f"replay_{'atk_' if attacked else ''}{strategy}"]
    if strategy != "chunked":
        assert _bits_equal(got, want), (strategy, got, want)
        return
    rows = sols
    if attacked:  # the rows as the sketch sees them: the Byzantine workers' payloads
        rows = core_dist._maybe_attack_chunked(core_dist.InProcessAxes({"data": M}, "cpu"),
                                               torch.from_numpy(sols), atk, ("data",), M).numpy()
    width = _bin_width(rows)
    assert (np.abs(got - want) <= width + 1e-7).all()
    assert (np.abs(got - np.median(rows, 0)) <= width + 1e-7).all()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_round_distributed_with_its_own_solver(ref, strategy):
    (x, y, _), out = ref
    got = one_round_distributed(quadratic_local_solver, _shards(x, y), _mesh(),
                                OneRoundConfig("median"), strategy=strategy).numpy()
    np.testing.assert_allclose(got, out[f"own_{strategy}"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_round_distributed_under_attack(ref, strategy):
    """tests/test_rounds.py's claim on every strategy: under sign_flip the
    median stays near w*, the mean does not."""
    (x, y, w_star), _ = ref
    atk = AttackConfig("sign_flip", alpha=0.25, scale=10.0)
    errs = {}
    for method in ("median", "mean"):
        w = one_round_distributed(quadratic_local_solver, _shards(x, y), _mesh(),
                                  OneRoundConfig(method), strategy=strategy, attack=atk)
        errs[method] = float(np.linalg.norm(w.numpy() - w_star))
    assert errs["median"] < 0.5 and errs["mean"] > 1.0, errs


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_local_update_round_matches_the_reference(ref, strategy):
    (x, y, _), out = ref
    cfg = LocalUpdateConfig(**LU)
    step = make_local_update_round(linreg_loss, cfg, _mesh(), strategy=strategy)
    shards = _shards(x, y)
    w = torch.zeros(D)
    for r in range(cfg.num_rounds):
        prev = w
        w = step(w, shards, r)
        want = out[f"lu_{strategy}_{r}"]
        if strategy != "chunked":
            np.testing.assert_allclose(w.numpy(), want, rtol=1e-6, atol=1e-7)
        else:  # this round's sketch of the accumulated gradients, one bin each
            delta = _deltas(prev, shards, cfg)
            err = np.abs(w.numpy() - want)
            assert (err <= cfg.step_size * _bin_width(delta) + 1e-6).all(), r
            w = torch.from_numpy(want.copy())  # the next round from the same iterate


def _deltas(w, shards, cfg):
    """The m accumulated local gradients of a round from ``w`` (numpy, (m, d))."""
    from repro_torch.rounds.distributed import scan_local_sgd

    rows = []
    for i in range(M):
        batch = (shards[0][i], shards[1][i])
        vg = torch.func.grad_and_value(linreg_loss)
        delta, _ = scan_local_sgd(lambda p: vg(p, batch)[::-1], w, cfg.tau, cfg.step_size)
        rows.append(delta.numpy())
    return np.stack(rows)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_collective_round_any_tau(ref, strategy):
    """The reference's structural claim, counted on the in-process axis:
    the collectives of a round do not grow with τ."""
    (x, y, _), _ = ref
    shards = _shards(x, y)

    def counts(tau):
        mesh = _mesh()
        step = make_local_update_round(linreg_loss, LocalUpdateConfig(**dict(LU, tau=tau)),
                                       mesh, strategy=strategy)
        step(torch.zeros(D), shards, 0)
        return dict(mesh.axes.calls)

    c1, c16 = counts(1), counts(16)
    assert c1 == c16 and sum(c16.values()) >= 1, (c1, c16)


def test_build_time_refusals():
    x, y, _ = _data(n=16)
    shards = _shards(x, y)
    mesh, cfg = _mesh(), LocalUpdateConfig(num_rounds=1)
    with pytest.raises(ValueError, match="omniscient"):
        one_round_distributed(quadratic_local_solver, shards, mesh, OneRoundConfig("median"),
                              strategy="chunked", attack=AttackConfig("mimic", alpha=0.25))
    with pytest.raises(ValueError, match="omniscient"):
        make_local_update_round(linreg_loss, cfg, mesh, strategy="chunked",
                                attack=AttackConfig("max_damage_tm", alpha=0.25))
    with pytest.raises(ValueError, match="adaptive"):
        make_local_update_round(linreg_loss, cfg, mesh, strategy="gather",
                                attack=AttackConfig("stale", alpha=0.25))
    with pytest.raises(ValueError, match="adaptive"):
        one_round_distributed(quadratic_local_solver, shards, mesh,
                              attack=AttackConfig("stale", alpha=0.25))
    with pytest.raises(ValueError, match="error-feedback"):
        make_local_update_round(linreg_loss, cfg, mesh, compression="topk")
    with pytest.raises(ValueError, match="error-feedback"):
        one_round_distributed(quadratic_local_solver, shards, mesh, compression="topk")
    with pytest.raises(ValueError, match="leading dim"):
        one_round_distributed(quadratic_local_solver, (shards[0][:4], shards[1][:4]), mesh)


@pytest.mark.parametrize("tau", [1, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_driven_round_program_is_the_bare_loop(strategy, tau):
    """tests/test_engine_equivalence.py's strategy axis: the round program
    as a scheduled round body of ``engine.run_scheduled`` gives the bare
    loop's bits (d = 6, n = 8, m = 8)."""
    x, y, _ = _data(n=8)
    shards = _shards(x, y)
    cfg = LocalUpdateConfig(**dict(LU, tau=tau))
    step = make_local_update_round(linreg_loss, cfg, _mesh(), strategy=strategy)
    w_ref = torch.zeros(D)
    for r in range(cfg.num_rounds):
        w_ref = step(w_ref, shards, r)

    def round_fn_for(attack):
        def fn(state, r):
            return dict(state, w=step(state["w"], shards, r), round=r + 1), None
        return fn

    state, hist = engine.run_scheduled(round_fn_for, engine.make_state(torch.zeros(D)),
                                       cfg.num_rounds, record=lambda r, a, s, e: {"round": r})
    assert _bits_equal(state["w"].numpy(), w_ref.numpy()), strategy
    assert [h["round"] for h in hist] == list(range(cfg.num_rounds))
