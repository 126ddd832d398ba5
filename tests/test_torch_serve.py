"""The port's serving path (repro_torch.launch.steps, repro_torch.serve) on
the CPU: against the reference where the reference runs here, and the
reference's own serving contracts (tests/test_serve.py) within the port.

The reference's ``ServeEngine`` fails in this JAX version (its params'
``device_put`` with a ``model``-axis sharding makes the embedding gather
raise ``ShardingTypeError``), so the port is held against the reference's
step functions on ``make_debug_mesh(1, 1)`` with unsharded params:
``launch.steps.make_slot_prefill_step`` / ``make_decode_pool_step`` /
``make_slot_admit_step`` (without the mesh), ``serve.adapt.make_round_fn`` and
``serve.traffic``.

Tolerances, stated where used:
- logits: 1e-5 absolute in float32 (magnitude < 1; observed ~2e-7);
- tokens: equal wherever the reference's top-2 logit gap exceeds twice
  the logit tolerance (two logit vectors within 1e-5 of each other pick
  the same argmax then); at a smaller gap a flip is allowed and the
  request's comparison ends there (its later tokens depend on it);
- adaptation round: gradient rows, aggregates and the new iterate within
  1e-6 + 1e-4 relative of the reference's, ``grad_norm`` within 1e-4
  relative (the packages sum in different orders);
- traffic draws (other generators than the reference's threefry) are held
  in distribution: two-sample Kolmogorov-Smirnov statistics below their
  alpha = 1e-3 critical value, frequencies within 0.04;
- everything within the port (slot placement, hot swap, snapshots,
  serving round vs offline round, restart replay, two CLI runs) is
  bitwise.
"""
import dataclasses
import math

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.fed.population import ArrivalConfig as RefArrivalConfig
from repro.launch import steps as RS
from repro.launch.mesh import make_debug_mesh
from repro.models import transformer as RT
from repro.serve import adapt as RAdapt
from repro.serve import engine as REngine
from repro.serve import traffic as RTraffic
from repro_torch import configs
from repro_torch.core import aggregators
from repro_torch.fed.population import ArrivalConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import steps
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.rounds import engine as rounds_engine
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import run as serve_run
from repro_torch.serve.adapt import (
    AdaptConfig, FeedbackAdapter, feedback_grad_rows, init_adapt_state, make_round_fn)
from repro_torch.serve.engine import Completed, Request, ServeConfig, ServeEngine, serve_stream
from repro_torch.serve.traffic import TrafficConfig, VirtualUsers
from repro_torch.tree import ravel, tree_leaves, tree_map

torch.set_num_threads(2)

SCFG = ServeConfig(slots=3, prompt_len=8, max_new=6, window=16)
LOGIT_TOL = 1e-5
TINY = dict(name="serve-test", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=128, dtype="float32")


def _cfgs():
    return (dataclasses.replace(ref_get_smoke_config("llama3_2_3b"), **TINY),
            dataclasses.replace(configs.get_smoke_config("llama3_2_3b"), **TINY))


@pytest.fixture(scope="module")
def setup():
    """tests/test_serve.py's tiny model in float32: the reference's init,
    carried over to the port."""
    rc, pc = _cfgs()
    rp = RT.init_params(rc, jax.random.PRNGKey(0))
    pp = convert.transformer_from_reference(pc, jax.tree.map(np.asarray, rp), device="cpu")
    return rc, pc, rp, pp


def _tcfg(cfg, alpha=0.0, shards=2, latency="zero", seed=0):
    return TrafficConfig(
        num_users=64, num_shards=shards, alpha=alpha, attack="feedback_flip",
        prompt_len=SCFG.prompt_len, min_gen=1, max_gen=SCFG.max_new, vocab=cfg.vocab,
        arrival=ArrivalConfig(latency=latency, scale=2.0), seed=seed)


def _assert_trees_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class _RecordingUsers(VirtualUsers):
    """VirtualUsers that records every round batch it builds."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.batches = []

    def build_round(self, per_shard, rnd):
        batch = super().build_round(per_shard, rnd)
        self.batches.append(batch)
        return batch


# ------------------------------------------------- engine vs the reference


class _RefGreedy:
    """The reference's batch-1 greedy decode through its slot steps (a
    one-slot pool), each step built once.  The admit step is built without
    the mesh, and the pool goes through the host between ticks: a pool
    pinned to the mesh (the admit's and the tick's outputs) makes the next
    tick raise ``ShardingTypeError`` here."""

    def __init__(self, rc, rp, cache_len):
        mesh = make_debug_mesh(1, 1)
        self.rc, self.rp, self.cache_len = rc, rp, cache_len
        self.prefill = RS.make_slot_prefill_step(rc, mesh, cache_len)
        self.decode = RS.make_decode_pool_step(rc, mesh)
        self.admit = RS.make_slot_admit_step()

    def __call__(self, prompt, gen_len):
        logits, cache = self.prefill(self.rp, jnp.asarray(prompt, jnp.int32)[None])
        toks = [int(jnp.argmax(logits[0, -1].astype(jnp.float32)))]
        pool = self.admit(RS.init_slot_pool(self.rc, 1, self.cache_len), cache, jnp.int32(0))
        pos = len(prompt)
        while len(toks) < gen_len:
            nxt, pool = self.decode(self.rp, jnp.asarray([[[toks[-1]]]], jnp.int32), pool,
                                    jnp.asarray([pos], jnp.int32))
            toks.append(int(nxt[0]))
            pool = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), pool)
            pos += 1
        return toks


def _teacher_forced(prefill, decode, prompt, toks):
    """Logits (len(toks), V) of every generation step, fed ``toks``."""
    logits, cache = prefill(prompt)
    out = [logits[0, -1]]
    for j, t in enumerate(toks[:-1]):
        logits, cache = decode(t, cache, len(prompt) + j)
        out.append(logits[0, 0])
    return np.stack([np.asarray(x, np.float32) for x in out])


def test_engine_tokens_and_logits_match_reference_steps(setup):
    """The port's engine (3 slots) on the port's own requests against the
    reference's batch-1 greedy decode through its slot steps: teacher-forced
    logits within 1e-5 at every step; tokens equal wherever the top-2 gap
    exceeds 2e-5, and at any flip the gap is asserted to be below that."""
    rc, pc, rp, pp = setup
    reqs = VirtualUsers(_tcfg(pc)).sample_requests(8)
    done = serve_stream(ServeEngine(pc, SCFG, pp), reqs)
    assert len(done) == len(reqs)
    cache_len = SCFG.cache_len
    greedy = _RefGreedy(rc, rp, cache_len)
    ref_prefill = jax.jit(lambda t: RT.prefill(rp, t, rc, kv_block=0, cache_len=cache_len))
    ref_decode = jax.jit(lambda t, cache, pos: RT.decode_step(rp, t, cache, pos, rc))
    flips = 0
    for c in sorted(done, key=lambda c: c.request.rid):
        req = c.request
        ref = greedy(req.prompt, req.gen_len)
        want = _teacher_forced(
            lambda p: ref_prefill(jnp.asarray(p, jnp.int32)[None]),
            lambda t, cache, pos: ref_decode(jnp.asarray([[t]], jnp.int32), cache,
                                             jnp.int32(pos)),
            req.prompt, ref)
        got = _teacher_forced(
            lambda p: T.prefill(pp, torch.as_tensor(p, dtype=torch.int64)[None], pc, kv_block=0,
                                cache_len=cache_len),
            lambda t, cache, pos: T.decode_step(pp, torch.tensor([[t]]), cache, pos, pc),
            req.prompt, ref)
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
        np.testing.assert_array_equal(want.argmax(-1), ref)  # the steps' tokens are greedy
        top2 = np.sort(want, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        for j, (a, b) in enumerate(zip(c.response, ref)):
            if a != b:
                assert gap[j] <= 2 * LOGIT_TOL, (req.rid, j, gap[j])
                flips += 1
                break
    assert flips <= 1


# ------------------------------------------------------ within the port


def test_slot_count_invariant_tokens(setup):
    """The same stream gives bitwise-identical responses on a 1-slot and a
    3-slot pool, and equal to a batch-1 prefill + decode loop outside the
    pool (launch.steps' slot prefill and plain decode steps)."""
    _, pc, _, pp = setup
    reqs = VirtualUsers(_tcfg(pc)).sample_requests(8)
    responses = {}
    for slots in (1, 3):
        engine = ServeEngine(pc, dataclasses.replace(SCFG, slots=slots), pp)
        done = serve_stream(engine, reqs)
        assert len(done) == len(reqs)
        responses[slots] = {c.request.rid: c.response for c in done}
    assert responses[1].keys() == responses[3].keys()
    for rid in responses[1]:
        np.testing.assert_array_equal(responses[1][rid], responses[3][rid])
    prefill = steps.make_slot_prefill_step(pc, SCFG.cache_len)
    decode = steps.make_decode_step(pc)
    for req in reqs[:4]:
        logits, cache = prefill(pp, torch.as_tensor(req.prompt, dtype=torch.int64)[None])
        toks, pos = [int(torch.argmax(logits[0, -1]))], SCFG.prompt_len
        while len(toks) < req.gen_len:
            logits, cache = decode(pp, torch.tensor([[toks[-1]]]), cache, pos)
            toks.append(int(torch.argmax(logits[0, 0])))
            pos += 1
        np.testing.assert_array_equal(responses[3][req.rid], np.asarray(toks, np.int32))


def test_storage_kept_across_admits_retires_and_swaps(setup):
    """The served parameters and the pool keep their storage across admits
    to different slots, retires, slot reuse, a hot swap and a second
    stream (the counterpart of the reference's no-recompile pin); the swap
    copies the new values in and refuses another shape or dtype."""
    _, pc, _, pp = setup
    engine = ServeEngine(pc, SCFG, pp)
    users = VirtualUsers(_tcfg(pc, latency="exponential"))
    done = serve_stream(engine, users.sample_requests(10))
    assert len(done) == 10
    bumped = tree_map(lambda w: w + torch.ones((), dtype=w.dtype), engine.params)
    assert engine.swap_params(bumped) == 1
    _assert_trees_bitwise(engine.params, bumped)
    assert not torch.equal(engine.params["embed"], pp["embed"])  # the caller's are untouched
    done2 = serve_stream(engine, users.sample_requests(6, stream=1))
    assert len(done2) == 6
    assert engine.storage_kept() == {"params": True, "pool": True}
    assert all(c.params_version == 1 for c in done2)
    wrong = dict(bumped, final_norm=bumped["final_norm"].double())
    with pytest.raises(ValueError, match="swap_params"):
        engine.swap_params(wrong)


def test_single_token_budget_completes_at_admit(setup):
    _, pc, _, pp = setup
    engine = ServeEngine(pc, SCFG, pp)
    req = Request(rid=0, uid=0, shard=0, arrival=0.0,
                  prompt=np.zeros((SCFG.prompt_len,), np.int32), gen_len=1)
    done = engine.admit(0, req)
    assert done is not None and done.response.shape == (1,)
    assert engine.num_active() == 0
    with pytest.raises(ValueError):
        engine.admit(0, dataclasses.replace(req, gen_len=SCFG.max_new + 1))


def test_hot_swap_and_snapshot_bit_equality(setup, tmp_path):
    """After serving with adaptation the engine serves exactly the
    adapter's iterate, every round swapped once, and the atomic-LATEST
    snapshot restores the RoundState bit for bit."""
    _, pc, _, pp = setup
    tcfg = _tcfg(pc, alpha=0.5, shards=2)
    users = VirtualUsers(tcfg)
    acfg = AdaptConfig(adapt_every=4, batch_per_shard=1)
    adapter = FeedbackAdapter(pc, acfg, users, pp, ckpt_dir=str(tmp_path))
    engine = ServeEngine(pc, SCFG, pp)
    serve_stream(engine, users.sample_requests(16), adapter=adapter)
    assert adapter.rounds_done >= 1
    assert engine.params_version == adapter.rounds_done
    _assert_trees_bitwise(engine.params, adapter.state["w"])
    assert engine.storage_kept() == {"params": True, "pool": True}
    assert rounds_engine.latest_round(str(tmp_path)) == adapter.rounds_done
    like = init_adapt_state(pp, acfg, tcfg.num_shards)
    restored, _host = rounds_engine.load_snapshot(str(tmp_path), like)
    assert int(restored["round"]) == adapter.rounds_done
    _assert_trees_bitwise(restored["w"], adapter.state["w"])
    _assert_trees_bitwise(restored["prev_agg"], adapter.state["prev_agg"])


def test_serving_round_equals_offline_round(setup):
    """The rounds fired inside serve_stream reproduce bit for bit when the
    identical batches drive the identical round function without an
    engine."""
    _, pc, _, pp = setup
    tcfg = _tcfg(pc, alpha=0.5, shards=2)
    users = _RecordingUsers(tcfg)
    acfg = AdaptConfig(adapt_every=4, batch_per_shard=1)
    online = FeedbackAdapter(pc, acfg, users, pp)
    engine = ServeEngine(pc, SCFG, pp)
    serve_stream(engine, users.sample_requests(16), adapter=online)
    assert len(users.batches) == online.rounds_done >= 1
    offline = FeedbackAdapter(pc, acfg, VirtualUsers(tcfg), pp)
    for batch in users.batches:
        offline.run_round(batch)
    _assert_trees_bitwise(online.state, offline.state)
    assert ([h["grad_norm"] for h in online.history]
            == [h["grad_norm"] for h in offline.history])


def test_restart_from_snapshot_replays_bit_for_bit(setup, tmp_path):
    """Restoring the round-1 snapshot and replaying the remaining round
    batches lands on the uninterrupted run's final iterate digest."""
    _, pc, _, pp = setup
    tcfg = _tcfg(pc, alpha=0.5, shards=2)
    users = _RecordingUsers(tcfg)
    acfg = AdaptConfig(adapt_every=3, batch_per_shard=1)
    full = FeedbackAdapter(pc, acfg, users, pp, ckpt_dir=str(tmp_path / "ck"))
    engine = ServeEngine(pc, SCFG, pp)
    serve_stream(engine, users.sample_requests(20), adapter=full)
    assert full.rounds_done >= 2
    like = init_adapt_state(pp, acfg, tcfg.num_shards)
    state, _host = rounds_engine.load_snapshot(str(tmp_path / "ck"), like, rnd=1)
    resumed = FeedbackAdapter(pc, acfg, VirtualUsers(tcfg), pp)
    resumed.state = state
    for batch in users.batches[1:]:
        resumed.run_round(batch)
    assert resumed.rounds_done == full.rounds_done
    assert serve_run.iterate_digest(resumed.state["w"]) == serve_run.iterate_digest(
        full.state["w"])


# ------------------------------------------------------ the adapter


def _completions(mod, m, B, prompt_len, vocab, seed):
    """m shards of B completions with numpy prompts and responses of
    varying length, as ``mod``'s Request/Completed (either package)."""
    rs = np.random.default_rng(seed)
    per_shard, rid = [], 0
    for s in range(m):
        row = []
        for _ in range(B):
            gen = int(rs.integers(1, 7))
            req = mod.Request(rid=rid, uid=s * 16, shard=s, arrival=0.0,
                              prompt=rs.integers(0, vocab, prompt_len).astype(np.int32),
                              gen_len=gen)
            row.append(mod.Completed(request=req,
                                     response=rs.integers(0, vocab, gen).astype(np.int32),
                                     admitted=0, finished=gen, params_version=0))
            rid += 1
        per_shard.append(row)
    return per_shard


@pytest.mark.parametrize("method,beta", [("median", 0.2), ("trimmed_mean", 0.25)])
def test_adaptation_round_matches_reference(setup, method, beta):
    """One round on the reference's own build_round batch (m = 4 shards,
    one feedback_flip Byzantine): the (m, D) rows, the aggregate, grad_norm
    and the new iterate against the reference's make_round_fn."""
    rc, pc, rp, pp = setup
    rtcfg = RTraffic.TrafficConfig(
        num_users=64, num_shards=4, alpha=0.25, attack="feedback_flip",
        prompt_len=SCFG.prompt_len, min_gen=1, max_gen=SCFG.max_new, vocab=rc.vocab,
        arrival=RefArrivalConfig(latency="zero"), seed=0)
    ref_batch = RTraffic.VirtualUsers(rtcfg).build_round(
        _completions(REngine, 4, 2, SCFG.prompt_len, rc.vocab, 9), rnd=0)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref_batch.items()}
    racfg = RAdapt.AdaptConfig(method=method, beta=beta, batch_per_shard=2)
    acfg = AdaptConfig(method=method, beta=beta, batch_per_shard=2)

    def close(got, want, what):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4, err_msg=what)

    rows_ref = RAdapt.feedback_grad_rows(rp, rc, ref_batch)
    rows = feedback_grad_rows(pp, pc, batch)
    assert tuple(rows.shape) == rows_ref.shape and rows.dtype == torch.float32
    close(rows.numpy(), rows_ref, "rows")
    close(aggregators.get_aggregator(method, beta)(rows).numpy(),
          np.asarray(RAdapt.aggregators.get_aggregator(method, beta)(rows_ref)), "aggregate")

    ref_state, ref_gn = RAdapt.make_round_fn(rc, racfg)(
        RAdapt.init_adapt_state(rp, racfg, 4), ref_batch)
    state, gn = make_round_fn(pc, acfg)(init_adapt_state(pp, acfg, 4), batch)
    np.testing.assert_allclose(float(gn), float(ref_gn), rtol=1e-4)
    close(state["prev_agg"].numpy(), ref_state["prev_agg"], "prev_agg")
    close(ravel(state["w"])[0].numpy(),
          np.asarray(jax.flatten_util.ravel_pytree(ref_state["w"])[0]), "w")
    assert int(state["round"]) == int(ref_state["round"]) == 1


def test_adapt_config_validation():
    with pytest.raises(ValueError):
        AdaptConfig(batch_per_shard=0)
    with pytest.raises(ValueError):
        AdaptConfig(adapt_every=0)
    with pytest.raises(ValueError, match="feedback"):
        AdaptConfig(grad_attack="feedback_flip", grad_alpha=0.5)
    with pytest.raises(ValueError):
        TrafficConfig(alpha=0.5, attack="sign_flip")


# ------------------------------------------------------------ traffic


def test_traffic_shard_mapping_and_corruption():
    """Contiguous uid->shard mapping and the Byzantine shards equal to the
    reference's, and build_round corrupting EXACTLY those shards' scores,
    deterministically per (seed, round)."""
    cfg = TrafficConfig(num_users=100, num_shards=4, alpha=0.3, attack="feedback_flip",
                        prompt_len=8, min_gen=1, max_gen=6, vocab=128,
                        arrival=ArrivalConfig(latency="zero"), seed=3)
    users = VirtualUsers(cfg)
    for users_, alpha in ((users, 0.3),) + tuple(
            (VirtualUsers(dataclasses.replace(cfg, alpha=a, num_shards=k)), a)
            for a in (0.0, 0.1, 0.5, 0.9) for k in (1, 3, 4, 7)):
        c = users_.cfg
        ref = RTraffic.VirtualUsers(RTraffic.TrafficConfig(
            num_users=c.num_users, num_shards=c.num_shards, alpha=alpha,
            attack="feedback_flip", arrival=RefArrivalConfig(latency="zero")))
        assert c.num_byz_shards == ref.cfg.num_byz_shards
        assert [users_.shard_of(u) for u in range(c.num_users)] == [
            ref.shard_of(u) for u in range(c.num_users)]
        assert [users_.is_byzantine(u) for u in range(c.num_users)] == [
            ref.is_byzantine(u) for u in range(c.num_users)]
    q = cfg.num_byz_shards
    assert q == 2
    per_shard = _completions(engine_mod, 4, 2, cfg.prompt_len, cfg.vocab, 4)
    b1 = users.build_round(per_shard, rnd=0)
    scores, honest = b1["scores"].numpy(), b1["scores_honest"].numpy()
    assert scores.shape == honest.shape == (4, 2)
    np.testing.assert_array_equal(scores[q:], honest[q:])
    np.testing.assert_array_equal(scores[:q], -honest[:q])  # feedback_flip negates
    b2 = VirtualUsers(cfg).build_round(per_shard, rnd=0)
    np.testing.assert_array_equal(scores, b2["scores"].numpy())
    w = b1["weights"].numpy()
    P = cfg.prompt_len
    np.testing.assert_array_equal(w[..., : P - 1], 0.0)
    np.testing.assert_allclose(w[..., P - 1], scores, rtol=1e-6)
    # the same batch as the reference's apart from the scores' noise
    ref_cfg = RTraffic.TrafficConfig(
        num_users=100, num_shards=4, alpha=0.3, attack="feedback_flip", prompt_len=8,
        min_gen=1, max_gen=6, vocab=128, arrival=RefArrivalConfig(latency="zero"), seed=3)
    ref = RTraffic.VirtualUsers(ref_cfg).build_round(
        _completions(REngine, 4, 2, cfg.prompt_len, cfg.vocab, 4), rnd=0)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b1[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_array_equal(b1["weights"].numpy() != 0, np.asarray(ref["weights"]) != 0)


def _ks(a, b):
    """Two-sample Kolmogorov-Smirnov statistic and its alpha = 1e-3 critical
    value."""
    a, b = np.sort(np.asarray(a, np.float64)), np.sort(np.asarray(b, np.float64))
    grid = np.concatenate([a, b])
    d = np.max(np.abs(np.searchsorted(a, grid, "right") / len(a)
                      - np.searchsorted(b, grid, "right") / len(b)))
    return d, 1.95 * math.sqrt((len(a) + len(b)) / (len(a) * len(b)))


@pytest.mark.parametrize("latency", ["exponential", "lognormal", "uniform"])
def test_traffic_draws_match_reference_in_distribution(latency):
    """3000 requests from each package: inter-arrival gaps and user ids by
    KS, generation lengths by frequency, prompts in their user's band; the
    honest scores by KS.  Within the port: deterministic per stream, ids
    unique across streams, a user's topic persistent."""
    n, vocab, spread = 3000, 1000, 32
    port = VirtualUsers(TrafficConfig(
        num_users=10**6, num_shards=4, prompt_len=8, min_gen=2, max_gen=9, vocab=vocab,
        topic_spread=spread, arrival=ArrivalConfig(latency=latency, scale=2.0, spread=0.8)))
    ref = RTraffic.VirtualUsers(RTraffic.TrafficConfig(
        num_users=10**6, num_shards=4, prompt_len=8, min_gen=2, max_gen=9, vocab=vocab,
        topic_spread=spread, arrival=RefArrivalConfig(latency=latency, scale=2.0, spread=0.8)))
    got, want = port.sample_requests(n), ref.sample_requests(n)
    for field in ("arrival", "uid"):
        a = np.array([getattr(r, field) for r in got], np.float64)
        b = np.array([getattr(r, field) for r in want], np.float64)
        if field == "arrival":
            assert np.all(np.diff(a) >= 0)
            a, b = np.diff(a, prepend=0.0), np.diff(b, prepend=0.0)
        d, crit = _ks(a, b)
        assert d < crit, (field, d, crit)
    gl, gr = (np.bincount([r.gen_len for r in rs], minlength=10) / n for rs in (got, want))
    assert gl[:2].sum() == 0 and np.abs(gl - gr).max() < 0.04
    centers = port.topic_centers(torch.tensor([r.uid for r in got])).numpy()
    offsets = (np.stack([r.prompt for r in got]) - centers[:, None]) % vocab
    assert offsets.max() < spread
    assert np.abs(np.bincount(offsets.ravel(), minlength=spread) / offsets.size
                  - 1.0 / spread).max() < 0.04
    for r in got[:50]:
        assert r.shard == port.shard_of(r.uid) and r.prompt.dtype == np.int32
    # scores of the same responses (no repeats: the noise term alone)
    resp = np.arange(5, dtype=np.int32)
    sp = [port.honest_score(Completed(r, resp, 0, 5, 0)) for r in got[:1500]]
    sr = [ref.honest_score(REngine.Completed(r, resp, 0, 5, 0)) for r in want[:1500]]
    d, crit = _ks(sp, sr)
    assert d < crit, ("scores", d, crit)
    again = port.sample_requests(n)
    assert all(a.uid == b.uid and a.arrival == b.arrival and np.array_equal(a.prompt, b.prompt)
               for a, b in zip(got, again))
    other = port.sample_requests(n, stream=1)
    assert {r.rid for r in other}.isdisjoint({r.rid for r in got})
    uid = torch.tensor([got[0].uid, got[0].uid])
    assert port.topic_centers(uid)[0] == port.topic_centers(uid)[1] == centers[0]


# ---------------------------------------------------------------- CLI


CLI = ["--device", "cpu", "--smoke", "--arch", "llama3_2_3b", "--requests", "12",
       "--slots", "2", "--shards", "2", "--num-users", "200", "--alpha", "0.5",
       "--attack", "feedback_flip", "--adapt-every", "6", "--batch-per-shard", "1",
       "--method", "median", "--latency", "zero"]


def test_cli_runs_twice_with_one_digest(capsys, tmp_path):
    """``python -m repro_torch.serve.run --device cpu --smoke``: every request
    served, rounds fired, the storage kept, and two runs print one sha256;
    the launch shim serves without adaptation; the default device is the
    card."""
    digests = []
    for i in range(2):
        assert serve_run.main(CLI + ["--ckpt-dir", str(tmp_path / f"ck{i}")]) == 0
        out = capsys.readouterr().out
        assert "served 12/12 requests" in out
        assert "storage kept: {'params': True, 'pool': True}" in out
        assert "adaptation rounds: " in out and "adaptation rounds: 0" not in out
        digests += [ln.split("= ")[1] for ln in out.splitlines()
                    if ln.startswith("final iterate sha256 = ")]
    assert len(digests) == 2 and digests[0] == digests[1]
    assert launch_serve.main(["--arch", "llama3.2-3b", "--smoke", "--batch", "2",
                              "--prompt-len", "8", "--gen", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 2/2 requests" in out and "adaptation rounds" not in out
    assert serve_run.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_run.main(["--smoke"])
