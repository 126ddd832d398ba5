"""The port's spans and counters (``repro_torch.trace``), on the CPU.

A tiny step of ``launch/steps.make_step_body`` (2 in-process workers, the
2-layer MoE smoke config, remat on, chunked attention) under a CPU
``torch.profiler``: no ``repro/`` event with tracing off, every span of the
module's table nested as listed with it on, and the same parameters bit
for bit either way.  The closed-form ``attn.kept`` against the mask the
attention builds, and the MoE's kept count against its routing.
"""
import dataclasses
import itertools

import pytest
import torch

torch.set_num_threads(2)

from repro_torch import configs, trace  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core.attacks import AttackConfig  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import trainer  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SEQ, BATCH, CHUNK = 16, 4, 8

#: each span's enclosing span in a step (worker.stack also copies an
#: attacked worker's rows where the attack maps over the workers)
PARENT = {"step": {None}, "worker.grads": {"step"}, "worker.fwd_bwd": {"worker.grads"},
          "block": {"worker.fwd_bwd"}, "attention": {"block"}, "moe.route": {"block"},
          "moe.experts": {"block"}, "worker.stack": {"worker.grads", "attack"},
          "aggregate": {"step"}, "attack": {"aggregate"}, "aggregate.select": {"aggregate"},
          "update": {"step"}}


def _window():
    cfg = dataclasses.replace(configs.get_smoke_config("granite_moe_1b_a400m"),
                              dtype="float32")
    mesh = mesh_lib.make_debug_mesh(2, device="cpu")
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", attn_chunk=CHUNK)
    opt = get_optimizer("adamw", 1e-3)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    window = trainer.make_window_step(cfg, pcfg, mesh, opt, AttackConfig("alie", 0.5), 1)
    gen = torch.Generator().manual_seed(0)
    batches = [{k: torch.randint(0, cfg.vocab, (1, BATCH, SEQ), generator=gen)
                for k in ("tokens", "labels")} for _ in range(2)]
    return cfg, window, state, batches


def _profiled(on: bool):
    """(the profiler's host events, the params after two steps, counts)"""
    from torch.profiler import ProfilerActivity, profile

    _, window, state, batches = _window()
    state = window(state, batches[0])  # the stacked buffers exist from here
    trace.take_counts()
    ctx = trace.enabled() if on else trace.NULL_SPAN
    with ctx, profile(activities=[ProfilerActivity.CPU]) as prof:
        state = window(state, batches[1])
    events = [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return events, [t.clone() for t in tree_leaves(state["params"])], trace.take_counts()


@pytest.fixture(scope="module")
def runs():
    return {on: _profiled(on) for on in (False, True)}


def _spans(events):
    return [e for e in events if e[0].startswith(trace.PREFIX)]


def _parent(span, spans):
    """The innermost span on the same thread that encloses ``span``."""
    _, tid, s, e = span
    outer = [o for o in spans if o is not span and o[1] == tid and o[2] <= s and e <= o[3]]
    return max(outer, key=lambda o: (o[2], -o[3]))[0][len(trace.PREFIX):] if outer else None


def test_off_a_span_is_the_shared_null_context_and_nothing_counts():
    assert not trace.on()
    assert trace.span("step", 3) is trace.NULL_SPAN is trace.span("attention")
    trace.take_counts()
    trace.count("attn.scores", 5)
    trace.count("moe.kept", torch.ones(3))
    assert trace.take_counts() == {}
    with trace.enabled():
        assert trace.on() and trace.span("step") is not trace.NULL_SPAN
        trace.count("attn.scores", 5)
        trace.count("attn.scores", 2)
        trace.count("moe.kept", torch.ones(3))
        trace.count("moe.kept", torch.arange(4))
    assert not trace.on()
    assert trace.take_counts() == {"attn.scores": 7, "moe.kept": 9.0}
    assert trace.take_counts() == {}


def test_off_the_trace_holds_no_span(runs):
    events, _, counts = runs[False]
    assert events and not _spans(events)
    assert counts == {}


def test_on_the_trace_holds_every_span_nested_as_listed(runs):
    spans = _spans(runs[True][0])
    names = {s[0][len(trace.PREFIX):] for s in spans}
    assert names == set(PARENT)
    for s in spans:
        name = s[0][len(trace.PREFIX):]
        assert _parent(s, spans) in PARENT[name], (name, _parent(s, spans))
    steps = [s for s in spans if s[0] == trace.PREFIX + "step"]
    assert len(steps) == 1
    # two workers, each a forward and (remat) a recompute of each super-block
    calls = {name: sum(s[0] == trace.PREFIX + name for s in spans) for name in PARENT}
    assert calls["worker.fwd_bwd"] == 2
    assert calls["block"] == calls["attention"] == calls["moe.route"] == 2 * 2 * 2


def test_the_counters_of_a_step(runs):
    cfg, counts = _window()[0], runs[True][2]
    blocks = SEQ // CHUNK
    calls = 2 * cfg.n_layers * 2  # workers x layers x (forward, recompute)
    rows = BATCH // 2
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    assert counts["attn.scores"] == calls * blocks * rows * kv * g * SEQ * CHUNK
    assert counts["attn.kept"] == calls * rows * kv * g * SEQ * (SEQ + 1) // 2
    assert counts["moe.pairs"] == calls * rows * SEQ * cfg.moe.top_k
    assert 0 < counts["moe.kept"] <= counts["moe.pairs"]


def test_the_parameters_are_the_same_bits_with_tracing_on_and_off(runs):
    off, on = runs[False][1], runs[True][1]
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sq,sk,q_offset,window,kv_block", [
    (sq, sk, qo, w, blk) for sq, sk, qo, w, blk in itertools.product(
        (1, 5, 16), (3, 16, 33), (0, 7), (0, 1, 6, 64), (4, 16))])
def test_the_closed_form_kept_count_is_the_mask_s(sq, sk, q_offset, window, kv_block):
    qpos = q_offset + torch.arange(sq)
    for causal in (True, False):
        want = got = 0
        for start in range(0, sk, kv_block):
            kpos = start + torch.arange(kv_block)  # the padded block, as chunked_attention's
            want += int((A._mask(qpos, kpos, causal, window) & (kpos < sk)[None, :]).sum())
            got += trace.kept_pairs(sq, q_offset, start, min(start + kv_block, sk), causal,
                                    window)
        assert got == want, causal


def test_the_attention_counts_its_blocks_padding_included():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(2, 10, 2, 3, 8, generator=gen)
    k, v = (torch.randn(2, 10, 2, 8, generator=gen) for _ in range(2))
    trace.take_counts()
    with trace.enabled():
        A.attention(q, k, v, window=4, kv_block=4)  # blocks of 4, 4 and 2 + 2 padding
    counts = trace.take_counts()
    qpos = torch.arange(10)
    assert counts["attn.scores"] == 2 * 2 * 3 * 10 * 12
    assert counts["attn.kept"] == 2 * 2 * 3 * int(A._mask(qpos, qpos, True, 4).sum())


def test_the_moe_dropped_share_is_its_routing_s():
    """Every token's router prefers the same two experts, so capacity drops."""
    gen = torch.Generator().manual_seed(2)
    b, s, d, e, f, k = 2, 32, 16, 8, 8, 2
    x = torch.randn(b, s, d, generator=gen)
    w_router = torch.randn(d, e, generator=gen) * 0.01
    w_router[:, :2] += x.mean((0, 1))[:, None] * 50  # experts 0 and 1 win everywhere
    w_gate, w_up = (torch.randn(e, d, f, generator=gen) for _ in range(2))
    w_down = torch.randn(e, f, d, generator=gen)
    trace.take_counts()
    with trace.enabled():
        moe.moe_ffn(x, w_router, w_gate, w_up, w_down, k)
    counts = trace.take_counts()
    probs = torch.softmax(x @ w_router, dim=-1)
    keep = moe.route(probs, k, moe.capacity(s, e, k)).keep
    share = 1 - counts["moe.kept"] / counts["moe.pairs"]
    assert share == pytest.approx(1 - float(keep.float().mean()), abs=1e-12)
    assert share > 0.3
