"""Device time by program span (``chipbench/spans.py``): a synthetic trace
with every rule of the attribution, and a real CPU profiler trace of the
port's attention forward and backward."""
from __future__ import annotations

import pytest
import torch

from chipbench import spans as S

torch.set_num_threads(2)

MAIN, AUTOGRAD = 1, 2  # thread ids


def op(name, tid, start, end, **kw):
    return S.Event(name, tid, start, end, **kw)


def kernel(start, end, linked=0, corr=0):
    return S.Event("kernel", 0, start, end, corr=corr, linked=linked, device=True)


@pytest.fixture()
def trace():
    """One step of one worker, in ns on one clock:

    main:      step [0, 1000] > worker.grads [5, 560] > worker.fwd_bwd [10, 500]
               > attention [20, 100] > aten::mm (seq 7) [30, 60]
               worker.fwd_bwd > aten::add [200, 210] (no finer span)
               worker.grads > worker.stack [520, 550] > aten::copy_ [521, 540]
               step > aggregate [600, 700] > attack [610, 650] > aten::mul [620, 630]
               cudaLaunchKernel [640, 645]: a launch no operation is linked to
               aten::zero_ [1100, 1110], outside every span
    autograd:  evaluate_function: MmBackward0 [300, 350] > MmBackward0 > aten::mm
               block's recompute: attention [360, 380] > aten::bmm [361, 370]
               evaluate_function: XBackward0 (seq 99, no forward op) > aten::mul
    """
    ev = [
        op("repro/step", MAIN, 0, 1000),
        op("repro/worker.grads", MAIN, 5, 560),
        op("repro/worker.fwd_bwd", MAIN, 10, 500),
        op("repro/attention", MAIN, 20, 100),
        op("aten::mm", MAIN, 30, 60, seq=7, corr=101),
        op("aten::add", MAIN, 200, 210, seq=8, corr=102),
        op("repro/worker.stack", MAIN, 520, 550),
        op("aten::copy_", MAIN, 521, 540, corr=107),
        op("repro/aggregate", MAIN, 600, 700),
        op("repro/attack", MAIN, 610, 650),
        op("aten::mul", MAIN, 620, 630, corr=103),
        op("aten::zero_", MAIN, 1100, 1110, corr=105),
        op("autograd::engine::evaluate_function: MmBackward0", AUTOGRAD, 300, 350, seq=7,
           fwd_tid=MAIN),
        op("MmBackward0", AUTOGRAD, 301, 349, seq=7, fwd_tid=MAIN),
        op("aten::mm", AUTOGRAD, 310, 340, corr=104),
        op("repro/attention", AUTOGRAD, 360, 380),
        op("aten::bmm", AUTOGRAD, 361, 370, seq=3, corr=106),
        op("autograd::engine::evaluate_function: XBackward0", AUTOGRAD, 400, 420, seq=99,
           fwd_tid=MAIN),
        op("aten::mul", AUTOGRAD, 405, 410, corr=108),
        op("cudaLaunchKernel", MAIN, 35, 40, corr=501, linked=101),
        op("cudaLaunchKernel", MAIN, 640, 645, corr=500),
        kernel(40, 90, linked=101, corr=501),  # attention, forward: 50
        kernel(205, 215, linked=102),  # worker.fwd_bwd: 10
        kernel(320, 340, linked=104),  # attention, backward: 20
        kernel(365, 375, linked=106),  # attention (recompute), forward: 10
        kernel(406, 412, linked=108),  # worker.fwd_bwd, backward (rule 4): 6
        kernel(525, 545, linked=107),  # worker.stack: 20
        kernel(625, 629, linked=103),  # attack: 4
        kernel(646, 700, corr=500),  # attack, through the runtime call: 54
        kernel(1105, 1112, linked=105),  # unspanned: 7
        kernel(1300, 1310, linked=105),  # unspanned: 10
        S.Event("repro/step", 0, 0, 1000, corr=900, device=True),  # the span's device copy
    ]
    return ev


def rows(events):
    return {r[0]: r[1:] for r in S.summary(events)["spans"]}


def test_each_rule_gives_the_expected_span(trace):
    t = rows(trace)
    ns = 1e-9
    # name: calls, self, subtree, backward
    assert t["attention"] == [2, pytest.approx(80 * ns), pytest.approx(80 * ns),
                              pytest.approx(20 * ns)]
    assert t["worker.fwd_bwd"] == [1, pytest.approx(16 * ns), pytest.approx(96 * ns),
                                   pytest.approx(6 * ns)]
    assert t["worker.stack"][1:3] == [pytest.approx(20 * ns)] * 2
    assert t["worker.grads"][1:3] == [0.0, pytest.approx(116 * ns)]
    assert t["attack"][1:3] == [pytest.approx(58 * ns)] * 2
    assert t["aggregate"][1:3] == [0.0, pytest.approx(58 * ns)]
    assert t["step"][1:3] == [0.0, pytest.approx(174 * ns)]
    assert t["unspanned"][1:3] == [pytest.approx(17 * ns)] * 2


def test_self_times_and_unspanned_add_up_to_the_activity(trace):
    s = S.summary(trace)
    assert sum(r[2] for r in s["spans"]) == pytest.approx(s["activity_s"])
    assert s["activity_s"] == pytest.approx(191e-9)
    assert s["busy_s"] == pytest.approx(191e-9)  # no two activities overlap


def test_the_recompute_span_nests_under_the_waiting_worker(trace):
    att = S.Attribution(trace)
    recompute = next(e for e in trace if e.name == "repro/attention" and e.tid == AUTOGRAD)
    assert att.chain(recompute) == ["attention", "worker.fwd_bwd", "worker.grads", "step"]


def test_idle_gaps_are_named_by_the_innermost_open_span(trace):
    idle = dict(S.summary(trace)["idle_spans"])
    # the gaps' middles: 147, 267, 352, 390 (the recompute's attention has
    # ended) and 468 in worker.fwd_bwd; 585 (worker.grads has ended) and 902
    # in step; 637 in attack; 1206 after the step
    assert idle == pytest.approx({"worker.fwd_bwd": (115 + 105 + 25 + 31 + 113) * 1e-9,
                                  "step": (80 + 405) * 1e-9, "attack": 17e-9,
                                  "none": 188e-9})


def test_metric_values_per_step():
    table = [["worker.grads", 4, 2.0, 14.0, 0.0], ["attention", 8, 6.0, 6.0, 2.0],
             ["moe.experts", 8, 3.0, 3.0, 1.0], ["aggregate", 1, 0.01, 0.41, 0.0],
             ["attack", 1, 0.4, 0.4, 0.0], ["update", 1, 0.2, 0.2, 0.0]]
    counts = {"attn.scores": 4096.0, "attn.kept": 2049.0, "moe.pairs": 100.0,
              "moe.kept": 95.0}
    v = S.metric_values(table, counts, 2)
    assert v == pytest.approx({"grads_dev_ms": 7000.0, "attn_dev_ms": 3000.0,
                               "moe_dev_ms": 1500.0, "attack_dev_ms": 200.0,
                               "aggregate_dev_ms": 5.0, "update_dev_ms": 100.0,
                               "attn_kept_share": 100 * 2049 / 4096,
                               "moe_dropped_share": 5.0})
    assert "moe_dev_ms" not in S.metric_values(table[:2], {}, 1)


def test_a_reader_reads_only_a_card_s_profile():
    from types import SimpleNamespace

    profile = {"spans": [["attention", 8, 6.0, 6.0, 2.0]], "counts": {}, "steps": 2}
    card = SimpleNamespace(device_type="cuda", profile=profile)
    assert S.read_metric(card, "attn_dev_ms") == pytest.approx(3000.0)
    assert S.read_metric(card, "moe_dev_ms") is None
    assert S.read_metric(SimpleNamespace(device_type="cpu", profile=profile),
                         "attn_dev_ms") is None


def test_a_real_cpu_trace_gives_the_attention_s_backward_to_it():
    """The backward's operations, on the calling thread here, land under
    ``attention`` as backward, through the nodes' sequence numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace as T
    from repro_torch.models import attention as A

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 12, 2, 2, 8, generator=gen, requires_grad=True)
    k, v = (torch.randn(1, 12, 2, 8, generator=gen, requires_grad=True) for _ in range(2))
    with T.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.span("loss"):
            loss = A.attention(q, k, v, kv_block=4).float().square().sum()
        torch.autograd.grad(loss, [q, k, v])  # as the port's step takes them
    events = S.events_of(prof.profiler.kineto_results.events())
    att = S.Attribution(events)
    inside_backward, forward = [], []
    for e in events:
        p, in_bwd = e.parent, False
        while p is not None:
            in_bwd = in_bwd or p.backward
            p = p.parent
        if e.name.startswith("aten::") and in_bwd:
            inside_backward.append(att.owner(e, e.tid, e.start))
        elif e.name in ("aten::bmm", "aten::exp"):
            forward.append(att.owner(e, e.tid, e.start))
    names = [(s.name if s is not None else None, b) for s, b in inside_backward]
    assert ("repro/attention", True) in names
    assert {b for _, b in names} == {True}
    assert {s for s, _ in names} <= {"repro/attention", "repro/loss"}
    assert forward and {(s.name, b) for s, b in forward} == {("repro/attention", False)}
