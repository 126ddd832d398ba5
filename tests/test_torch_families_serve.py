"""The port's serving path (the engine, the slot pool, the feedback adapter)
on the MoE, SSM and hybrid families, on the CPU, against the reference's
step functions and adaptation round, held as tests/test_torch_serve.py
holds the dense model (the reference's ``ServeEngine`` raises
``ShardingTypeError`` under this JAX version).

Smoke widths in float32, the reference's init carried over.  Tolerances
(tests/test_torch_serve.py's): teacher-forced logits 1e-5 absolute;
tokens equal wherever the reference's top-2 gap exceeds 2e-5; the
adaptation round's rows, aggregate and new iterate within 1e-6 + 1e-4
relative, grad_norm 1e-4 relative.
"""
import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.fed.population import ArrivalConfig as RefArrivalConfig
from repro.models import transformer as RT
from repro.serve import adapt as RAdapt
from repro.serve import engine as REngine
from repro.serve import traffic as RTraffic
from repro_torch import configs
from repro_torch.core import aggregators
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.serve.adapt import (AdaptConfig, feedback_grad_rows, init_adapt_state,
                                     make_round_fn)
from repro_torch.serve.engine import ServeEngine, serve_stream
from repro_torch.serve.traffic import VirtualUsers
from repro_torch.tree import ravel
from test_torch_serve import LOGIT_TOL, SCFG, _completions, _RefGreedy, _tcfg, _teacher_forced

torch.set_num_threads(2)

FAMILIES = ("granite_moe_1b_a400m", "grok_1_314b", "mamba2_2_7b", "recurrentgemma_2b")


def _models(arch):
    rc = dataclasses.replace(ref_get_smoke_config(arch), dtype="float32")
    pc = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    rp = RT.init_params(rc, jax.random.PRNGKey(0))
    pp = convert.transformer_from_reference(pc, jax.tree.map(np.asarray, rp), device="cpu")
    return rc, pc, rp, pp


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_tokens_and_logits_match_reference_steps(arch):
    """The port's engine (3 slots, every cache kind in the pool) on its own
    requests against the reference's batch-1 greedy decode through its slot
    steps, and teacher-forced logits; the served tensors keep their
    storage."""
    rc, pc, rp, pp = _models(arch)
    reqs = VirtualUsers(_tcfg(pc)).sample_requests(6)
    engine = ServeEngine(pc, SCFG, pp)
    done = serve_stream(engine, reqs)
    assert len(done) == len(reqs)
    assert engine.storage_kept() == {"params": True, "pool": True}
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
        np.testing.assert_array_equal(want.argmax(-1), ref)
        top2 = np.sort(want, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        for j, (a, b) in enumerate(zip(c.response, ref)):
            if a != b:
                assert gap[j] <= 2 * LOGIT_TOL, (req.rid, j, gap[j])
                flips += 1
                break
    assert flips <= 1


def test_slot_pool_layout_and_admit_replace_every_state():
    """recurrentgemma's pool: block leaves (n_super, slots, ...), tail leaves
    (slots, ...), kpos a row per slot; an admit overwrites the slot's
    attention rows and recurrent states wholesale and leaves the others."""
    from repro_torch.launch import steps

    _, pc, _, pp = _models("recurrentgemma_2b")
    pool = steps.init_slot_pool(pc, 3, 10, device="cpu")
    blk, tail = pool["blocks"], pool["tail"]
    assert tuple(blk["p0_rec"]["h"].shape) == (1, 3, pc.d_model)
    assert tuple(blk["p2_attn"]["kpos"].shape) == (1, 3, 10)
    assert tuple(tail[1]["conv"].shape) == (3, 3, pc.d_model)
    for leaf in (blk["p0_rec"]["h"], tail[0]["h"], blk["p2_attn"]["k"]):
        leaf.fill_(7.0)
    _, one = steps.make_slot_prefill_step(pc, 10)(pp, torch.arange(6)[None])
    steps.make_slot_admit_step()(pool, one, 1)
    assert torch.equal(blk["p0_rec"]["h"][:, 1], one["blocks"]["p0_rec"]["h"][:, 0])
    assert torch.equal(tail[0]["h"][1], one["tail"][0]["h"][0])
    assert torch.equal(blk["p2_attn"]["kpos"][:, 1], one["blocks"]["p2_attn"]["kpos"])
    assert bool((blk["p2_attn"]["kpos"][:, 0] == -1).all())
    assert bool((tail[0]["h"][[0, 2]] == 7.0).all())


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "granite_moe_1b_a400m", "recurrentgemma_2b"])
@pytest.mark.parametrize("method,beta", [("median", 0.2), ("trimmed_mean", 0.25)])
def test_adaptation_round_matches_reference(arch, method, beta):
    """One round on the reference's own build_round batch (m = 4 shards, one
    feedback_flip Byzantine) for mamba2 (float32 SSM leaves in ravel order),
    granite (MoE, the aux loss outside the adapter's NLL) and recurrentgemma
    (the unrolled tail's leaves after the blocks in each row): the (m, D)
    rows, the aggregate, grad_norm and the new iterate against the
    reference's make_round_fn."""
    rc, pc, rp, pp = _models(arch)
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
    assert tuple(rows.shape) == rows_ref.shape == (4, T.count_params(pc))
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


def test_bf16_round_keeps_the_float32_leaves():
    """In a bf16 mamba2 the adapter's update rebuilds every leaf in its own
    dtype: A_log / dt_bias / D_skip stay float32, and the served copy takes
    the swap."""
    pc = dataclasses.replace(configs.get_smoke_config("mamba2_2_7b"))
    pp = T.init_params(pc, seed=0, device="cpu")
    users = VirtualUsers(_tcfg(pc, alpha=0.5, shards=2))
    from repro_torch.serve.adapt import FeedbackAdapter

    adapter = FeedbackAdapter(pc, AdaptConfig(adapt_every=4, batch_per_shard=1), users, pp)
    engine = ServeEngine(pc, SCFG, pp)
    serve_stream(engine, users.sample_requests(10), adapter=adapter)
    assert adapter.rounds_done >= 1 and engine.params_version == adapter.rounds_done
    w = adapter.state["w"]["blocks"]["p0_ssm"]
    assert w["A_log"].dtype == w["dt_bias"].dtype == torch.float32
    assert w["w_in"].dtype == torch.bfloat16
    assert not torch.equal(w["dt_bias"], pp["blocks"]["p0_ssm"]["dt_bias"])
    assert engine.storage_kept() == {"params": True, "pool": True}
