"""Federated streaming rounds on the port against the JAX reference (CPU).

The port's population draws its shards from a counter-based generator
that cannot reproduce JAX's threefry streams, so the slice is compared
through :class:`RefBackedPopulation`, a test subclass of the port's
``ClientPopulation`` that serves the reference population's shards,
optimum and cohorts as numpy.  The port's own population is held to the
reference's population contracts instead.

Tolerances:
- cohort aggregates: the two packages compute each client's gradient
  from the same shard with float32 products in different orders, so rows
  differ by a few ulps; a value near a bin edge may then change bins.  The
  streaming estimators are held to one bin width per coordinate (the
  sketch's own error bound), the means to 1e-5 relative, and the exact
  median to 1e-5 absolute.
- trajectories: per-round ``err`` is held to 1e-4 absolute over 4 rounds
  (observed: at most ~1e-6): the aggregates agree to a few ulps unless a
  row changes bins, and a changed bin moves the step by lr * width in one
  coordinate.
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

from repro.core.attacks import AttackConfig as JAttackConfig
from repro.fed import rounds as JR
from repro.fed.population import ClientPopulation as JPopulation
from repro.fed.population import PopulationConfig as JPopulationConfig
from repro.optim.optimizers import get_optimizer as jget_optimizer
from repro.rounds import engine as jengine
from repro_torch import rng
from repro_torch.core.attacks import AttackConfig
from repro_torch.fed import rounds as R
from repro_torch.fed.population import ClientPopulation, PopulationConfig
from repro_torch.kernels import histogram_agg as H
from repro_torch.models import convert
from repro_torch.rounds import engine

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class RefBackedPopulation(ClientPopulation):
    """The port's population serving the reference population's data: its
    shards, w* and per-round cohorts (test-only)."""

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
        return torch.from_numpy(np.asarray(self.ref.sample_cohort(key, cohort_size),
                                           np.int64))


@functools.lru_cache(maxsize=None)
def _pops(alpha=0.1, dim=16, clients=2000, n=32, seed=0):
    """(reference population, its RefBackedPopulation), shared by the tests
    so that JAX compiles each population's functions once."""
    ref = JPopulation(JPopulationConfig(num_clients=clients, samples_per_client=n,
                                        dim=dim, alpha=alpha, seed=seed))
    return ref, RefBackedPopulation(ref)


def _attacks(name, **kw):
    return JAttackConfig(name, alpha=0.1, **kw), AttackConfig(name, alpha=0.1, **kw)


# ------------------------------------------------------------- population


def test_population_deterministic_lazy_and_chunk_invariant():
    pop = ClientPopulation(PopulationConfig(num_clients=10_000, dim=8, seed=1), device="cpu")
    ids = torch.tensor([0, 17, 9999, 4242, 5])
    w = torch.zeros(8)
    g1 = pop.client_grads(w, ids)
    assert torch.equal(g1, pop.client_grads(w, ids))  # regenerable => two-pass safe
    assert not torch.allclose(g1[0], g1[1])  # different clients, different shards
    parts = torch.cat([pop.client_grads(w, ids[:2]), pop.client_grads(w, ids[2:3]),
                       pop.client_grads(w, ids[3:])])
    assert torch.equal(g1, parts)  # a client's shard ignores its chunk
    x, y = pop.client_batch(ids)
    assert x.shape == (5, 32, 8) and y.shape == (5, 32)
    other = ClientPopulation(PopulationConfig(num_clients=10_000, dim=8, seed=2), device="cpu")
    assert not torch.equal(other.client_batch(ids)[0], x)


def test_counter_normals_are_standard_and_keyed():
    ids = torch.arange(4000)
    z = rng.normal(3, 1, ids, 25)
    assert z.dtype == torch.float32 and z.shape == (4000, 25)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    assert torch.equal(z[17:19], rng.normal(3, 1, ids[17:19], 25))
    assert torch.equal(z[:, :10], rng.normal(3, 1, ids, 10))  # prefix-stable
    assert not torch.equal(z[:2], rng.normal(3, 2, ids[:2], 25))  # tag
    assert not torch.equal(z[:2], rng.normal(4, 1, ids[:2], 25))  # seed


def test_cohort_sampling_without_replacement():
    pop = ClientPopulation(PopulationConfig(num_clients=500, dim=4), device="cpu")
    ids = pop.sample_cohort(0, 3, 200)
    assert len(torch.unique(ids)) == 200 and ids.min() >= 0 and ids.max() < 500
    assert torch.equal(ids, pop.sample_cohort(0, 3, 200))
    assert not torch.equal(ids, pop.sample_cohort(0, 4, 200))
    with pytest.raises(ValueError, match="cohort"):
        pop.sample_cohort(0, 0, 501)


def test_byzantine_subpopulation():
    pop = ClientPopulation(PopulationConfig(num_clients=1000, alpha=0.1, dim=4), device="cpu")
    assert pop.cfg.num_byzantine() == 100
    mask = pop.is_byzantine(torch.arange(1000))
    assert int(mask.sum()) == 100 and bool(mask[:100].all())


def test_heterogeneity_shifts_optima():
    kw = dict(num_clients=100, dim=16, noise=0.0, seed=2)
    iid = ClientPopulation(PopulationConfig(**kw), device="cpu")
    het = ClientPopulation(PopulationConfig(heterogeneity=1.0, **kw), device="cpu")
    ids = torch.arange(64)
    assert float(iid.client_grads(iid.w_star, ids).abs().max()) < 1e-5
    assert float(het.client_grads(het.w_star, ids).norm(dim=1).mean()) > 0.1


def test_client_deltas_are_accumulated_local_gradients():
    pop = ClientPopulation(PopulationConfig(num_clients=100, dim=6, seed=4), device="cpu")
    ids, w = torch.arange(10), torch.full((6,), 0.1)
    # per-client iterates take another product order than the shared one
    torch.testing.assert_close(pop.client_deltas(w, ids, 1, 0.1), pop.client_grads(w, ids),
                               rtol=1e-6, atol=1e-7)
    x, y = pop.client_batch(ids)
    wi, acc = w.expand(10, -1), torch.zeros(10, 6)
    for _ in range(3):  # the reference's scan body, client by client
        g = torch.stack([x[i].T @ (x[i] @ wi[i] - y[i]) / 32 for i in range(10)])
        acc, wi = acc + g, wi - 0.05 * g
    torch.testing.assert_close(pop.client_deltas(w, ids, 3, 0.05), acc, rtol=1e-5, atol=1e-6)


# -------------------------------------------------- the slice, against the reference


def _cohort_rows(pop, w, ids, rcfg, atk):
    """The attacked cohort matrix, materialized (the oracle for bin widths;
    the port's rows equal the reference's to a few ulps)."""
    bounds = R._chunk_bounds(ids.shape[0], rcfg.chunk_clients)
    fn = R._make_chunk_fn(pop, w, ids, bounds, atk)
    return torch.cat([fn(j) for j in range(len(bounds))]).numpy()


@pytest.mark.parametrize("attack", ["sign_flip", "alie"])
@pytest.mark.parametrize("method", ["approx_median", "approx_trimmed_mean", "stream_mean",
                                    "median"])
def test_aggregate_cohort_matches_reference(method, attack):
    ref, port = _pops(dim=8, n=16)
    jatk, atk = _attacks(attack, scale=10.0)
    w_np = (0.5 * np.asarray(ref.w_star)).astype(np.float32)
    ids = ref.sample_cohort(jax.random.PRNGKey(1), 128)
    kw = dict(cohort_size=128, chunk_clients=64, method=method, nbins=512, beta=0.15)
    tids = torch.from_numpy(np.asarray(ids, np.int64))
    got = R.aggregate_cohort(port, torch.from_numpy(w_np), tids, R.RoundConfig(**kw),
                             atk).numpy()
    full = _cohort_rows(port, torch.from_numpy(w_np), tids, R.RoundConfig(**kw), atk)
    width = (full.max(0) - full.min(0)) / 512
    backends = ("xla", "pallas") if method.startswith("approx") else ("xla",)
    for backend in backends:
        want = np.asarray(JR.aggregate_cohort(ref, jnp.asarray(w_np), ids,
                                              JR.RoundConfig(backend=backend, **kw), jatk))
        if method == "stream_mean":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        elif method == "median":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert (np.abs(got - want) <= width * 1.0001 + 1e-6).all(), backend


def _trajectories(optimizer, schedule, rounds=4, ckpt_dir=None, compression="none"):
    ref, port = _pops(dim=8, clients=1000, n=16)
    kw = dict(num_rounds=rounds, cohort_size=128, chunk_clients=64, method="approx_median",
              nbins=256, optimizer=optimizer, lr=0.3, seed=0, compression=compression)
    names = ("sign_flip", "alie")
    jmix = JR.AttackMixture(tuple(_attacks(a)[0] for a in names), schedule)
    mix = R.AttackMixture(tuple(_attacks(a)[1] for a in names), schedule)
    _, jh = JR.run_rounds(ref, JR.RoundConfig(backend="xla", **kw), jmix,
                          ckpt_every=2 if ckpt_dir else 0, ckpt_dir=ckpt_dir)
    _, th = R.run_rounds(port, R.RoundConfig(**kw), mix)
    return ref, port, kw, mix, jh, th


@pytest.mark.parametrize("optimizer,schedule", [("sgd", "cycle"), ("sgd", "greedy"),
                                                ("adamw", "cycle"), ("adamw", "greedy")])
def test_run_rounds_matches_reference(optimizer, schedule):
    _, _, _, _, jh, th = _trajectories(optimizer, schedule)
    assert [h["attack"] for h in th] == [h["attack"] for h in jh]
    np.testing.assert_allclose([h["err"] for h in th], [h["err"] for h in jh],
                               rtol=0, atol=1e-4)
    assert th[-1]["err"] < th[0]["err"]


def test_resume_from_reference_state_continues_its_trajectory(tmp_path):
    """models.convert carries the reference's round-2 state (a non-zero
    iterate and AdamW moments) into the port, which resumes from it."""
    ck = str(tmp_path / "ref")
    ref, port, kw, mix, jh, th = _trajectories("adamw", "greedy", ckpt_dir=ck)
    jopt = jget_optimizer("adamw", 0.3)
    w0 = jnp.zeros(8)
    like = jengine.make_state(w0, comp_res=(), opt_state=jopt.init(w0),
                              key=jax.random.PRNGKey(0))
    jstate, host = jengine.load_snapshot(ck, like, 2)
    state_np = jax.tree.map(np.asarray, jstate)
    assert int(state_np["round"]) == 2 and np.abs(state_np["opt_state"]["m"]).max() > 0
    state = convert.round_state_from_reference(state_np, seed=0, device="cpu")
    port_ck = str(tmp_path / "port")
    engine.save_snapshot(port_ck, state, host=host)
    _, resumed = R.run_rounds(port, R.RoundConfig(**kw), mix, ckpt_dir=port_ck,
                              resume=True)
    assert [h["round"] for h in resumed] == [0, 1, 2, 3]
    np.testing.assert_allclose([h["err"] for h in resumed[2:]], [h["err"] for h in jh[2:]],
                               rtol=0, atol=1e-4)


def test_resume_from_reference_state_carries_its_error_feedback_residual(tmp_path):
    """A reference snapshot taken under topk (an error-feedback codec: a
    (clients, d) residual that outlives the rounds a client sits out) at
    round 2 resumes on the port through models.convert, residual included:
    the resumed rounds' err within 1e-4 of the reference's own run.  A
    residual of another row width is refused."""
    ck = str(tmp_path / "ref")
    ref, port, kw, mix, jh, th = _trajectories("sgd", "cycle", ckpt_dir=ck, compression="topk")
    w0 = jnp.zeros(8)
    like = jengine.make_state(w0, comp_res=JR.init_comp_residual(ref, JR.RoundConfig(**kw)),
                              opt_state=(), key=jax.random.PRNGKey(0))
    jstate, host = jengine.load_snapshot(ck, like, 2)
    state_np = jax.tree.map(np.asarray, jstate)
    assert state_np["comp_res"].shape == (1000, 8) and np.abs(state_np["comp_res"]).max() > 0
    state = convert.round_state_from_reference(state_np, seed=0, device="cpu")
    np.testing.assert_array_equal(state["comp_res"].numpy(), state_np["comp_res"])
    port_ck = str(tmp_path / "port")
    engine.save_snapshot(port_ck, state, host=host)
    _, resumed = R.run_rounds(port, R.RoundConfig(**kw), mix, ckpt_dir=port_ck, resume=True)
    assert [h["round"] for h in resumed] == [0, 1, 2, 3]
    np.testing.assert_allclose([h["err"] for h in resumed[2:]], [h["err"] for h in jh[2:]],
                               rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="comp_res"):
        convert.round_state_from_reference(dict(state_np, comp_res=np.zeros((3, 5), np.float32)),
                                           device="cpu")


# ------------------------------------------------------- the port's own contracts


def _own_pop(alpha=0.1):
    return ClientPopulation(PopulationConfig(num_clients=2000, samples_per_client=32, dim=16,
                                             alpha=alpha, seed=0), device="cpu")


def _run_own(method, attack, rounds=8, **kw):
    rcfg = R.RoundConfig(num_rounds=rounds, cohort_size=256, chunk_clients=64, method=method,
                         nbins=256, lr=0.2, seed=0)
    mix = R.AttackMixture((AttackConfig(attack, alpha=0.1, **kw),))
    return R.run_rounds(_own_pop(), rcfg, mix)[1]


def test_sign_flip_median_converges_mean_diverges():
    med = _run_own("approx_median", "sign_flip", scale=100.0)
    mean = _run_own("stream_mean", "sign_flip", scale=100.0)
    assert med[-1]["err"] < med[0]["err"] and med[-1]["err"] < 0.5, med[-1]
    assert mean[-1]["err"] > 10 * med[-1]["err"], (mean[-1], med[-1])


def test_alie_trimmed_mean_converges():
    tm = _run_own("approx_trimmed_mean", "alie", shift=1.0)
    assert tm[-1]["err"] < tm[0]["err"] and tm[-1]["err"] < 0.5, tm[-1]


def test_kill_and_resume_is_bit_identical(tmp_path):
    pop = _own_pop()
    rcfg = R.RoundConfig(num_rounds=4, cohort_size=128, chunk_clients=48,
                         method="approx_trimmed_mean", nbins=64, optimizer="adamw", lr=0.1)
    mix = R.AttackMixture((AttackConfig("sign_flip", alpha=0.1),
                           AttackConfig("stale", alpha=0.1)), "greedy")
    ck = str(tmp_path / "ck")
    w_full, h_full = R.run_rounds(pop, rcfg, mix, ckpt_every=1, ckpt_dir=ck)
    assert engine.snapshot_rounds(ck) == [1, 2, 3, 4]
    w_plain, h_plain = R.run_rounds(pop, rcfg, mix)
    assert torch.equal(w_full, w_plain) and h_full == h_plain
    w_r, h_r = R.run_rounds(pop, rcfg, mix, ckpt_dir=ck, resume=2)
    assert torch.equal(w_r, w_full) and h_r == h_full


def test_cli_runs_on_cpu_and_is_deterministic(capsys):
    from repro_torch.fed import run

    argv = ["--device", "cpu", "--clients", "500", "--cohort", "64", "--chunk", "16",
            "--rounds", "2", "--dim", "8", "--alpha", "0.1", "--attack", "sign_flip,alie"]
    out = subprocess.run([sys.executable, "-m", "repro_torch.fed.run", *argv],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "round   1  attack=alie" in out.stdout
    assert run.main(argv) == 0  # the same run again, in this process
    digest = r"final iterate sha256 = ([0-9a-f]{64})"
    assert re.search(digest, out.stdout).group(1) == \
        re.search(digest, capsys.readouterr().out).group(1)


def test_no_fallback_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA: the default device is legitimately the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClientPopulation(PopulationConfig(num_clients=10, dim=2))
    from repro_torch.fed import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--clients", "100", "--cohort", "16", "--rounds", "1", "--dim", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        H.load()
