"""Buffered async federated rounds of the port (repro_torch.fed.async_rounds,
the arrival model, ArrivalScheduler) against the JAX reference (CPU).

JAX's threefry draws cannot be reproduced, so:
- the port's arrival model is held in distribution: for each latency
  model, 2*10^4 draws of each package; the port's mean lies within 5
  standard errors of the reference's (the two samples' pooled error), and
  the port's p-quantile (p = 0.1, 0.5, 0.9) lies between the reference's
  (p - delta)- and (p + delta)-quantiles, delta = 5 * sqrt(2 p (1-p) / n);
  the dropout rate lies within 3 sigma of the configured rate;
- whole trajectories are held by ``RefBackedAsyncPopulation``, which
  serves the reference's shards, cohorts, churn joiners and arrival draws
  for the keys run_async_rounds derives: the buffer composition and the
  history's host fields (duration, buffer, pending, staleness_mean,
  timing) are EQUAL, and per-round ``err`` is within 1e-4 absolute (the
  fed tests' bound: gradients differ by a few ulps between the packages).
Host-only pieces (_time_byzantine, ArrivalScheduler) are held bitwise.
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attacks.schedule import ArrivalScheduler as JArrivalScheduler
from repro.core.attacks import AttackConfig as JAttackConfig
from repro.fed import async_rounds as JA
from repro.fed import rounds as JR
from repro.fed.population import ArrivalConfig as JArrivalConfig
from repro.fed.population import ClientPopulation as JPopulation
from repro.fed.population import PopulationConfig as JPopulationConfig
from repro_torch.attacks.schedule import ARRIVAL_MODES, ArrivalScheduler
from repro_torch.core.attacks import AttackConfig
from repro_torch.fed import async_rounds as A
from repro_torch.fed import rounds as R
from repro_torch.fed.async_rounds import AsyncConfig, run_async_rounds
from repro_torch.fed.population import (ARRIVAL_STREAM, ArrivalConfig, ClientPopulation,
                                        PopulationConfig)
from repro_torch.rounds import engine

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class RefBackedAsyncPopulation(ClientPopulation):
    """The port's population serving the reference population's shards,
    w*, cohorts, churn joiners and arrival times (test-only)."""

    def __init__(self, ref: JPopulation):
        super().__init__(PopulationConfig(**dataclasses.asdict(ref.cfg)), device="cpu")
        self.ref = ref
        self.w_star = torch.from_numpy(np.array(ref.w_star))
        self._batch = jax.jit(ref.client_batch)

    def client_batch(self, client_ids):
        x, y = self._batch(jnp.asarray(client_ids.numpy(), jnp.int32))
        return torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))

    def sample_cohort(self, seed, rnd, cohort_size):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        return torch.from_numpy(np.asarray(self.ref.sample_cohort(key, cohort_size), np.int64))

    @staticmethod
    def _arrival_key(seed, rnd, stream):
        root = jax.random.fold_in(jax.random.PRNGKey(seed), ARRIVAL_STREAM)
        return jax.random.fold_in(jax.random.fold_in(root, rnd), stream)

    def sample_joiners(self, seed, rnd, n):
        ids = self.ref.sample_cohort(self._arrival_key(seed, rnd, 1), n)
        return torch.from_numpy(np.asarray(ids, np.int64))

    def arrival_times(self, seed, rnd, stream, client_ids, acfg):
        t = self.ref.arrival_times(self._arrival_key(seed, rnd, stream),
                                   jnp.asarray(client_ids.numpy(), jnp.int32),
                                   JArrivalConfig(**dataclasses.asdict(acfg)))
        return torch.from_numpy(np.array(t))


POP_KW = dict(num_clients=400, samples_per_client=16, dim=8, alpha=0.1, noise=0.5, seed=0)


@functools.lru_cache(maxsize=None)
def _pops():
    ref = JPopulation(JPopulationConfig(**POP_KW))
    return ref, RefBackedAsyncPopulation(ref)


def _own_pop(alpha=0.1, clients=400):
    return ClientPopulation(PopulationConfig(**dict(POP_KW, alpha=alpha, num_clients=clients)),
                            device="cpu")


def _rcfg(rounds=4, cohort=32, chunk=16, method="median", **kw):
    return R.RoundConfig(num_rounds=rounds, cohort_size=cohort, chunk_clients=chunk,
                         method=method, lr=0.3, seed=0, **kw)


# ------------------------------------------------------------ configs


@pytest.mark.parametrize("kw", [dict(latency="gaussian"), dict(dropout=1.0),
                                dict(dropout=-0.1), dict(churn=-0.1)])
def test_arrival_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        JArrivalConfig(**kw)
    with pytest.raises(ValueError) as got:
        ArrivalConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(buffer_k=0), dict(max_staleness=0),
                                dict(policy="nonexistent")])
def test_async_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        JA.AsyncConfig(**kw)
    with pytest.raises(ValueError) as got:
        AsyncConfig(**kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- arrival model


def test_zero_latency_is_zero_and_models_finite_positive():
    pop = _own_pop()
    ids = torch.arange(64)
    assert torch.equal(pop.arrival_times(0, 0, 0, ids, ArrivalConfig()), torch.zeros(64))
    for latency in ("uniform", "exponential", "lognormal"):
        t = pop.arrival_times(0, 1, 0, ids, ArrivalConfig(latency=latency))
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert bool(torch.isfinite(t).all()) and bool((t >= 0).all())
        assert len(torch.unique(t)) > 1


def test_dropout_is_honest_only():
    pop = _own_pop(alpha=0.25, clients=200)
    ids = torch.arange(200)
    t = pop.arrival_times(0, 2, 0, ids, ArrivalConfig(latency="uniform", dropout=0.5))
    byz = pop.is_byzantine(ids)
    assert bool(torch.isfinite(t[byz]).all())  # the adversary never no-shows
    assert int(torch.isinf(t[~byz]).sum()) > 0
    assert bool(torch.isfinite(pop.arrival_times(0, 2, 0, ids,
                                                 ArrivalConfig(latency="uniform"))).all())


def test_client_speed_persists_across_rounds():
    pop = _own_pop()
    ids = torch.arange(50)
    acfg = ArrivalConfig(latency="uniform", client_spread=1.0)
    s = pop.client_speed(ids, acfg)
    assert torch.equal(s, pop.client_speed(ids.flip(0), acfg).flip(0))
    assert len(torch.unique(s)) > 1
    assert torch.equal(pop.client_speed(ids, ArrivalConfig()), torch.ones(50))
    # a client's speed is the same in every round, so it cancels in the
    # ratio of its times in two rounds
    t1 = pop.arrival_times(0, 1, 0, ids, acfg)
    t2 = pop.arrival_times(0, 2, 0, ids, acfg)
    bare = ArrivalConfig(latency="uniform")
    r1 = pop.arrival_times(0, 1, 0, ids, bare)
    r2 = pop.arrival_times(0, 2, 0, ids, bare)
    torch.testing.assert_close(t1 / t2, r1 / r2, rtol=1e-5, atol=0)


def test_draws_deterministic_and_invariant_to_order_and_chunking():
    pop = _own_pop()
    ids = pop.sample_cohort(0, 3, 64)
    acfg = ArrivalConfig(latency="lognormal", dropout=0.2, client_spread=0.5)
    t = pop.arrival_times(0, 3, 0, ids, acfg)
    assert torch.equal(t, pop.arrival_times(0, 3, 0, ids, acfg))
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(t[perm], pop.arrival_times(0, 3, 0, ids[perm], acfg))
    parts = torch.cat([pop.arrival_times(0, 3, 0, ids[a:a + 10], acfg)
                       for a in range(0, 64, 10)])
    assert torch.equal(t, parts)
    assert not torch.equal(t, pop.arrival_times(0, 4, 0, ids, acfg))  # round
    assert not torch.equal(t, pop.arrival_times(0, 3, 2, ids, acfg))  # stream
    assert not torch.equal(t, pop.arrival_times(1, 3, 0, ids, acfg))  # seed


def test_arrival_stream_does_not_perturb_cohorts():
    pop = _own_pop()
    for r in range(3):
        cohort = pop.sample_cohort(0, r, 32)
        joiners = pop.sample_joiners(0, r, 32)
        assert not torch.equal(cohort, joiners)  # joiners draw a stream of their own
        assert torch.equal(cohort, pop.sample_cohort(0, r, 32))
    rcfg = _rcfg(rounds=3)
    w_sync, _ = R.run_rounds(_own_pop(alpha=0.0), rcfg)
    w_async, _ = run_async_rounds(_own_pop(alpha=0.0), rcfg, AsyncConfig(buffer_k=32),
                                  ArrivalConfig(latency="zero"))
    assert torch.equal(w_sync, w_async)


N_DRAWS = 20_000


@pytest.mark.parametrize("acfg", [
    dict(latency="uniform", scale=1.5, spread=0.8),
    dict(latency="exponential", scale=2.0),
    dict(latency="lognormal", spread=1.0),
    dict(latency="lognormal", spread=0.5, client_spread=0.5),
], ids=["uniform", "exponential", "lognormal", "lognormal+speed"])
def test_latencies_match_reference_in_distribution(acfg):
    cfg = dict(POP_KW, num_clients=N_DRAWS, alpha=0.0)
    ref = JPopulation(JPopulationConfig(**cfg))
    pop = ClientPopulation(PopulationConfig(**cfg), device="cpu")
    ids = np.arange(N_DRAWS)
    want = np.asarray(ref.arrival_times(jax.random.PRNGKey(5), jnp.asarray(ids, jnp.int32),
                                        JArrivalConfig(**acfg)), np.float64)
    got = pop.arrival_times(5, 0, 0, torch.from_numpy(ids), ArrivalConfig(**acfg)).numpy()
    got = got.astype(np.float64)
    se = np.sqrt((want.var() + got.var()) / N_DRAWS)
    assert abs(got.mean() - want.mean()) < 5 * se, (got.mean(), want.mean(), se)
    for p in (0.1, 0.5, 0.9):
        delta = 5 * np.sqrt(2 * p * (1 - p) / N_DRAWS)
        lo, hi = np.quantile(want, [p - delta, p + delta])
        assert lo <= np.quantile(got, p) <= hi, (p, np.quantile(got, p), lo, hi)


def test_dropout_rate_matches_reference():
    p = 0.25
    cfg = dict(POP_KW, num_clients=N_DRAWS, alpha=0.1)
    ref = JPopulation(JPopulationConfig(**cfg))
    pop = ClientPopulation(PopulationConfig(**cfg), device="cpu")
    ids = np.arange(N_DRAWS)
    honest = ids >= pop.cfg.num_byzantine()
    acfg = dict(latency="exponential", dropout=p)
    want = np.asarray(ref.arrival_times(jax.random.PRNGKey(1), jnp.asarray(ids, jnp.int32),
                                        JArrivalConfig(**acfg)))
    got = pop.arrival_times(1, 0, 0, torch.from_numpy(ids), ArrivalConfig(**acfg)).numpy()
    sigma = np.sqrt(p * (1 - p) / honest.sum())
    for t in (want, got):
        assert np.isfinite(t[~honest]).all()
        assert abs(np.isinf(t[honest]).mean() - p) < 3 * sigma


# ------------------------------------------------ host scheduling pieces


def test_arrival_scheduler_matches_reference():
    got, want = ArrivalScheduler(reexplore=5), JArrivalScheduler(reexplore=5)
    damages = [0.3, -0.1, 0.7, 0.2, 0.0, -0.4, 0.9, 0.1, 0.5, 0.5, -0.2, 0.3]
    for r, dmg in enumerate(damages):
        assert got.pick(r) == want.pick(r)
        got.feedback(r, dmg)
        want.feedback(r, dmg)
        assert got.state_dict() == want.state_dict()
    assert got.best() == want.best()
    restored = ArrivalScheduler(reexplore=5)
    restored.load_state_dict(want.state_dict())
    assert restored.pick(len(damages)) == want.pick(len(damages))
    assert ArrivalScheduler().modes == ARRIVAL_MODES
    with pytest.raises(ValueError, match="unknown arrival mode"):
        ArrivalScheduler(modes=("honest", "teleport"))
    with pytest.raises(ValueError, match="modes"):
        ArrivalScheduler(modes=("first",)).load_state_dict(want.state_dict())


def _timing_cases():
    rng = np.random.default_rng(3)
    t = rng.exponential(1.0, 24)
    t[[2, 9]] = np.inf
    byz = np.zeros(24, bool)
    byz[[0, 5, 11, 17]] = True
    cases = []
    for mode in ("first", "last", "honest"):
        for k in (12, 3, 2):  # k - q = 8, -1 (want <= 0), q = 4 > k
            for timeout in (None, 0.3):
                cases.append((t, byz, mode, k, timeout))
    cases.append((t, np.zeros(24, bool), "last", 12, None))  # q = 0
    short = np.asarray([0.2, np.inf, 0.4, 0.1])
    cases.append((short, np.asarray([True, False, False, False]), "last", 4, None))
    return cases


@pytest.mark.parametrize("t,byz,mode,k,timeout", _timing_cases())
def test_time_byzantine_bitwise_reference(t, byz, mode, k, timeout):
    got_t, got_p = t.copy(), np.zeros(len(t), np.int64)
    want_t, want_p = t.copy(), np.zeros(len(t), np.int64)
    A._time_byzantine(got_t, got_p, byz, mode, k, timeout)
    JA._time_byzantine(want_t, want_p, byz, mode, k, timeout)
    assert np.array_equal(got_t, want_t) and np.array_equal(got_p, want_p)


# ------------------------------------------------------------ sync pin


@pytest.mark.parametrize("mixture", [
    R.AttackMixture(),
    R.AttackMixture((AttackConfig("sign_flip", alpha=0.1, scale=50.0),)),
    R.AttackMixture((AttackConfig("sign_flip", alpha=0.1),
                     AttackConfig("alie", alpha=0.1, shift=1.0))),
], ids=["clean", "sign_flip", "mixture"])
@pytest.mark.parametrize("method", ["median", "approx_median"])
def test_sync_pin_bitwise_run_rounds(mixture, method, monkeypatch):
    calls = []
    real = R.aggregate_cohort
    monkeypatch.setattr(A.sync_rounds, "aggregate_cohort",
                        lambda *a, **kw: calls.append(kw["rnd"]) or real(*a, **kw))
    pop = _own_pop()
    rcfg = _rcfg(rounds=5, method=method)
    w_sync, h_sync = R.run_rounds(pop, rcfg, mixture)
    calls.clear()
    w_async, h_async = run_async_rounds(pop, rcfg, AsyncConfig(buffer_k=rcfg.cohort_size),
                                        ArrivalConfig(latency="zero"), mixture)
    assert calls == list(range(rcfg.num_rounds))  # the fast path, every round
    assert torch.equal(w_sync, w_async)
    for hs, ha in zip(h_sync, h_async):
        assert (hs["err"], hs["grad_norm"], hs["attack"]) == \
            (ha["err"], ha["grad_norm"], ha["attack"])
        assert ha["duration"] == 0.0 and ha["staleness_mean"] == 0.0
        assert ha["buffer"] == rcfg.cohort_size and ha["pending"] == 0


def test_slow_path_under_latency(monkeypatch):
    calls = []
    monkeypatch.setattr(A.sync_rounds, "aggregate_cohort", lambda *a, **kw: calls.append(1))
    run_async_rounds(_own_pop(), _rcfg(), AsyncConfig(buffer_k=16),
                     ArrivalConfig(latency="lognormal"))
    assert calls == []


# ---------------------------------------------- trajectories vs reference

ASYNC_RUNS = [(policy, method, "stale_exploit")
              for policy in ("none", "damped", "trim_late", "drop")
              for method in ("median", "approx_median")]
ASYNC_RUNS.append(("damped", "median", "stale_exploit_greedy"))


@pytest.mark.parametrize("policy,method,attack", ASYNC_RUNS)
def test_trajectory_matches_reference(policy, method, attack):
    ref, port = _pops()
    kw = dict(num_rounds=4, cohort_size=32, chunk_clients=16, method=method, lr=0.3,
              seed=0, beta=0.2, nbins=64)
    arr = dict(latency="lognormal", dropout=0.25, churn=0.1, client_spread=0.5)
    acfg = dict(buffer_k=16, max_staleness=2, policy=policy, timeout=1.2)
    _, want = JA.run_async_rounds(
        ref, JR.RoundConfig(backend="xla", **kw), JA.AsyncConfig(**acfg),
        JArrivalConfig(**arr), JR.AttackMixture((JAttackConfig(attack, alpha=0.1),)))
    _, got = run_async_rounds(
        port, R.RoundConfig(**kw), AsyncConfig(**acfg), ArrivalConfig(**arr),
        R.AttackMixture((AttackConfig(attack, alpha=0.1),)))
    host = ("round", "attack", "duration", "buffer", "pending", "staleness_mean", "timing")
    assert [{k: h[k] for k in host} for h in got] == [{k: h[k] for k in host} for h in want]
    assert any(h["staleness_mean"] > 0 for h in got) and any(h["pending"] for h in got)
    np.testing.assert_allclose([h["err"] for h in got], [h["err"] for h in want],
                               rtol=0, atol=1e-4)


# ----------------------------------------------------- the port's own


def test_kill_and_resume_is_bit_identical(tmp_path):
    pop = _own_pop()
    rcfg = _rcfg(rounds=5, method="approx_trimmed_mean", optimizer="adamw", beta=0.2)
    acfg = AsyncConfig(buffer_k=12, max_staleness=2, policy="damped", timeout=2.0)
    arr = ArrivalConfig(latency="lognormal", dropout=0.2, churn=0.1)
    mix = R.AttackMixture((AttackConfig("stale_exploit_greedy", alpha=0.1),
                           AttackConfig("sign_flip", alpha=0.1)), "greedy")
    ck = str(tmp_path / "ck")
    w_full, h_full = run_async_rounds(pop, rcfg, acfg, arr, mix, ckpt_every=1, ckpt_dir=ck)
    assert engine.snapshot_rounds(ck) == [1, 2, 3, 4, 5]
    assert any(h["pending"] for h in h_full)
    w_plain, h_plain = run_async_rounds(pop, rcfg, acfg, arr, mix)
    assert torch.equal(w_full, w_plain) and h_full == h_plain
    w_r, h_r = run_async_rounds(pop, rcfg, acfg, arr, mix, ckpt_dir=ck, resume=2)
    assert torch.equal(w_r, w_full) and h_r == h_full


def test_compression_is_refused():
    with pytest.raises(ValueError, match="does not thread compression"):
        run_async_rounds(_own_pop(), _rcfg(compression="int8"), AsyncConfig(buffer_k=8))


CLI = ["--device", "cpu", "--clients", "300", "--cohort", "32", "--chunk", "16",
       "--rounds", "3", "--dim", "8", "--alpha", "0.1", "--attack", "stale_exploit",
       "--method", "median", "--async-buffer", "16", "--latency", "lognormal",
       "--dropout", "0.1", "--churn", "0.1", "--staleness-policy", "damped"]


def test_cli_async_is_deterministic(capsys):
    from repro_torch.fed import run

    out = subprocess.run([sys.executable, "-m", "repro_torch.fed.run", *CLI],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "effective-m async rate" in out.stdout
    assert "buf=" in out.stdout and "stale=" in out.stdout and "t=" in out.stdout
    assert run.main(CLI) == 0  # the same run again, in this process
    digest = r"final iterate sha256 = ([0-9a-f]{64})"
    assert re.search(digest, out.stdout).group(1) == \
        re.search(digest, capsys.readouterr().out).group(1)


def test_cli_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA: the default device is legitimately the card")
    from repro_torch.fed import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(CLI[2:])


def test_empty_buffer_is_a_null_round():
    """A timeout before every arrival leaves the buffer empty: the port
    aggregates nothing (a zero step, the reference's stated null round);
    the reference reaches ``weights.min()`` on the empty buffer first and
    raises."""
    rcfg = _rcfg(rounds=2)
    acfg = dict(buffer_k=8, timeout=1e-6)
    arr = dict(latency="uniform", scale=1.0)
    with pytest.raises(ValueError, match="zero-size"):
        JA.run_async_rounds(_pops()[0], JR.RoundConfig(backend="xla", **dataclasses.asdict(
            rcfg)), JA.AsyncConfig(**acfg), JArrivalConfig(**arr))
    w, hist = run_async_rounds(_own_pop(), rcfg, AsyncConfig(**acfg), ArrivalConfig(**arr))
    assert torch.equal(w, torch.zeros(8))
    assert [(h["buffer"], h["grad_norm"], h["duration"]) for h in hist] == [(0, 0.0, 1e-6)] * 2
    assert hist[-1]["pending"] > 0
