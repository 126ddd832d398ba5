"""The port's dry-run (``repro_torch.launch.dryrun``): the counterparts of
tests/test_dryrun_lite.py on fake process groups in subprocesses (one smoke
config of each of the six families, train and decode, at (data 4, model
2); the multi mesh (2, 2, 2) with the gather, bucketed and hierarchical
strategies; fsdp; seq_parallel; a long-context decode), ``fsdp_dims``
avoiding the model dim, ``long_context_cfg`` against the reference's for
every architecture × shape, one production-width combo (llama3.2-3b
``decode_32k`` on the single mesh) with its collective bytes against their
closed form and again through the reference's entry point ``run_combo``
(in a process of its own, which joins the fake group itself), the kernel
ops' fake implementations, and the committed
sweep ``dryrun_torch_results.jsonl`` (the counterparts of
tests/test_deliverables.py's dry-run checks, and the robust gather's bytes
of ``train_4k`` against their closed form).

Every comparison of counts is exact (bytes are sums of integer sizes).
Serial time about 25 s: two subprocesses plan the smoke combos (each
under its own fake group in turn) while a third plans the production
combo.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from repro.configs import ARCHITECTURES as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import steps as RS
from repro_torch import configs
from repro_torch.kernels import histogram_agg, robust_agg
from repro_torch.launch import dryrun, report, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSONL = os.path.join(ROOT, "dryrun_torch_results.jsonl")
FAMS = ["llama3.2-3b", "granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b",
        "whisper-small", "internvl2-1b"]
PCFG = {"agg_method": "median", "agg_strategy": "gather", "remat": True, "attn_chunk": 16}
TRAIN, DECODE = ["t", 64, 8, "train"], ["d", 64, 8, "decode"]


def _spec(arch, shape, sizes=(0, 4, 2), mesh="single", **kw):
    return dict({"arch": arch, "smoke": True, "shape": shape, "mesh": mesh,
                 "sizes": list(sizes), "pcfg": PCFG}, **kw)


SMOKE = {}
for _arch in FAMS:
    SMOKE[(_arch, "train")] = _spec(_arch, TRAIN)
    SMOKE[(_arch, "decode")] = _spec(_arch, DECODE)
for _strategy in ("gather", "bucketed", "hierarchical"):
    SMOKE[("multi", _strategy)] = _spec(
        "qwen3-14b", ["t", 32, 8, "train"], (2, 2, 2), "multi", optimizer="sgd",
        pcfg={"agg_method": "median", "agg_strategy": _strategy, "remat": False,
              "attn_chunk": 0})
SMOKE[("seq_parallel", "train")] = _spec("llama3.2-3b", TRAIN,
                                         pcfg=dict(PCFG, seq_parallel=True))
SMOKE[("fsdp", "train")] = _spec("llama3.2-3b", TRAIN, pcfg=dict(PCFG, param_mode="fsdp"))
SMOKE[("window", "train")] = _spec("llama3.2-3b", TRAIN, device_steps=2)
LONG = ["long_500k", 8192, 1, "decode"]  # scaled-down long-context
SMOKE[("long", "mamba2-2.7b")] = _spec("mamba2-2.7b", LONG, (0, 2, 2))
SMOKE[("long", "llama3.2-3b")] = _spec("llama3.2-3b", LONG, (0, 2, 2),
                                       over={"long_context_window": 64})
PRODUCTION = {"arch": "llama3.2-3b", "shape": "decode_32k", "mesh": "single"}
RUN_COMBO = ("import json; from repro_torch.configs import ParallelConfig; "
             "from repro_torch.launch.dryrun import run_combo; "
             "print(json.dumps(run_combo('llama3.2-3b', 'decode_32k', 'single', "
             "ParallelConfig())))")


def _run_combo():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", RUN_COMBO], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def plans():
    """Every smoke combo's record (two subprocesses, each planning its half
    in turn) and the production combo's (a third), all at once."""
    keys = list(SMOKE)
    halves = [keys[::2], keys[1::2]]
    with ThreadPoolExecutor(4) as pool:
        prod = pool.submit(dryrun.plan_in_subprocess, PRODUCTION, 600)
        combo = pool.submit(_run_combo)
        done = list(pool.map(lambda ks: dryrun.plan_in_subprocess([SMOKE[k] for k in ks], 600),
                             halves))
        out = {k: r for ks, recs in zip(halves, done) for k, r in zip(ks, recs)}
        out["production"] = prod.result()
        out["run_combo"] = combo.result()
    return out


def _ok(rec):
    assert rec.get("status") == "ok", (rec.get("error"), rec.get("trace"))
    return rec


@pytest.mark.parametrize("arch", FAMS)
def test_train_and_decode_plan_at_data_four_model_two(plans, arch):
    """Train (the robust gather over the data axis: one all-gather, B1
    launches) and decode plan for each family at (4, 2).  Decode aggregates
    nothing: its one kernel is the MoE combine, where the family has one."""
    train, decode = _ok(plans[(arch, "train")]), _ok(plans[(arch, "decode")])
    assert train["mesh_shape"] == {"data": 4, "model": 2} and train["workers"] == 4
    assert train["kernel_launches"].get("median", 0) >= 1
    assert train["collectives_by_axis"]["data"]["all-gather"] > 0
    assert train["flops"] > 0 and train["peak_memory_in_bytes"] > train["argument_size_in_bytes"]
    combine = {"moe_combine"} if configs.get_config(arch).moe is not None else set()
    assert set(train["kernel_launches"]) == {"median"} | combine | {c + "_backward"
                                                                   for c in combine}
    assert decode["flops"] > 0 and set(decode["kernel_launches"]) == combine
    for rec in (train, decode):
        assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
        assert set(rec["links"].values()) == {450e9}  # 8 ranks: one host


@pytest.mark.parametrize("strategy", ["gather", "bucketed", "hierarchical"])
def test_multi_pod_mesh_plan(plans, strategy):
    """The (pod 2, data 2, model 2) mesh: robust aggregation across ('pod',
    'data') jointly: an all-gather or all-to-all over the worker axes."""
    rec = _ok(plans[("multi", strategy)])
    assert rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 2} and rec["workers"] == 4
    over_workers = {k: v for a, c in rec["collectives_by_axis"].items()
                    if a in ("pod", "data", "pod+data") for k, v in c.items() if v}
    assert {"all-gather", "all-to-all"} & set(over_workers), rec["collectives_by_axis"]


def test_seq_parallel_fsdp_and_window_plans(plans):
    """seq_parallel, fsdp and a device-steps window of 2 plan at (4, 2); the
    window makes two steps' aggregations."""
    base = _ok(plans[("llama3.2-3b", "train")])
    for key in (("seq_parallel", "train"), ("fsdp", "train")):
        _ok(plans[key])
    assert plans[("fsdp", "train")]["param_mode"] == "fsdp"
    assert plans[("fsdp", "train")]["argument_size_in_bytes"] < base["argument_size_in_bytes"]
    window = _ok(plans[("window", "train")])
    assert window["kernel_launches"]["median"] == 2 * base["kernel_launches"]["median"]


def test_long_context_decode_plans():
    """long_500k-style decode for an SSM (native) and the dense sliding-window
    variant, whose cache is window-sized."""
    cfg = dataclasses.replace(configs.get_smoke_config("llama3.2-3b"), long_context_window=64)
    shape = configs.ShapeConfig(*LONG)
    cfg = steps.long_context_cfg(cfg, shape)
    assert cfg.name.endswith("+swa")
    ins = steps.input_specs(cfg, shape, mesh_lib.make_debug_mesh(2, 2, device="cpu"))
    assert ins["cache"]["blocks"]["p0_attn"]["k"].meta.shape[2] == 64


def test_long_context_decode_plan_records(plans):
    assert _ok(plans[("long", "llama3.2-3b")])["variant"].endswith("+swa")
    assert _ok(plans[("long", "mamba2-2.7b")])["variant"] == "mamba2-smoke"


def test_fsdp_dims_avoid_model_tp_dim():
    """fsdp must not take the tensor-parallel dim where another dim divides
    (the reference's grok finding)."""
    mesh = mesh_lib.make_debug_mesh(4, 2, device="cpu")
    for arch in ("grok-1-314b", "llama3-405b", "qwen3-14b"):
        cfg = configs.get_config(arch)
        specs, dims = steps.fsdp_param_shardings(cfg, mesh)
        pairs = []
        tree_map(lambda _, s, d: pairs.append((s, d)), T.meta_params(cfg), specs, dims)
        n_2d = 0
        for s, d in pairs:
            if d >= 0:
                assert s[d] == "data", (arch, s, d)
                n_2d += "model" in s
        assert n_2d > 0, arch


def test_long_context_cfg_matches_the_reference():
    assert configs.ARCHITECTURES == REF_ARCHS and list(configs.INPUT_SHAPES) == list(REF_SHAPES)
    for arch in REF_ARCHS:
        for name, shape in REF_SHAPES.items():
            want = RS.long_context_cfg(ref_get_config(arch), shape).name
            got = steps.long_context_cfg(configs.get_config(arch),
                                         configs.INPUT_SHAPES[name]).name
            assert got == want, (arch, name)


def test_production_decode_bytes_match_their_closed_form(plans):
    """llama3.2-3b decode_32k on the single mesh (data 16 × model 16): 8 kv
    heads do not divide 16, so rank 0 attends with one kv head's group
    (``padded``): a layer moves the products' q, k and v columns of its
    head and the attention output's columns of its ``wo`` rows, one
    all-to-all each (8 tokens: the products, not the weights); the logits
    are gathered over V; the embedding's lookup and each attention's and
    FFN's row-parallel output are all-reduced.  No leaf is gathered whole.
    No robust aggregation runs in decode (no kernel launch)."""
    rec = _ok(plans["production"])
    cfg = configs.get_config("llama3.2-3b")
    L, D, H, KV, hd, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.vocab)
    rows, s, M = 128 // 16, 2, 16  # a worker's batch rows; bf16; the model axis
    gather = rows * V * s
    reduce = (2 * L + 1) * rows * D * s
    a2a = L * rows * (H // KV * hd + 2 * hd + H * hd // M) * s
    assert rec["mesh_shape"] == {"data": 16, "model": 16} and rec["workers"] == 16
    assert rec["collectives_by_axis"] == {"model": {"all-gather": gather, "all-reduce": reduce,
                                                    "all-to-all": a2a}}
    assert rec["collectives"]["total"] == gather + 2 * reduce + a2a
    assert rec["kernel_launches"] == {} and rec["links"] == {"model": 50e9}


def test_kernel_ops_give_shapes_under_fake_tensors_without_building():
    """Under FakeTensorMode (fake CUDA tensors) and on meta stand-ins the
    five kernel entry points return their outputs' shapes and dtypes;
    nothing is built or launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    libs = robust_agg.select_libraries()
    with FakeTensorMode():
        for dev in ("cuda", "meta"):
            xs = [torch.empty(10, n, device=dev) for n in (7, 33, 4096)]
            meds = robust_agg.median_many(xs)
            assert [tuple(m.shape) for m in meds] == [(7,), (33,), (4096,)]
            tms = robust_agg.trimmed_mean_many(xs, 2)
            assert all(t.dtype == torch.float32 and t.device.type == dev for t in tms)
            med, tm = robust_agg.fused_median_trimmed(
                torch.empty(5, 9, dtype=torch.bfloat16, device=dev), 1)
            assert med.shape == tm.shape == (9,) and med.dtype == torch.bfloat16
            chunk = torch.empty(512, 32, dtype=torch.bfloat16, device=dev)
            lo, hi = histogram_agg.minmax(chunk)
            assert lo.shape == hi.shape == (32,) and lo.dtype == torch.float32
            counts, sums = histogram_agg.histogram(chunk, lo, hi, 64)
            assert counts.shape == sums.shape == (64, 32)
            counts, sums = histogram_agg.histogram(chunk, lo, hi, 64, with_sums=False)
            assert counts.shape == (64, 32) and sums is None
    assert robust_agg.select_libraries() == libs
    assert not any(robust_agg.LAUNCHES.values()) and not any(histogram_agg.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the committed sweep
# ---------------------------------------------------------------------------


def _sweep():
    with open(JSONL) as f:
        return [json.loads(line) for line in f]


def test_sweep_covers_all_combos_both_meshes():
    rows = {(r["arch"], r["shape"], r["mesh"]): r["status"] for r in _sweep()}
    want = {(a, s, m) for a in configs.ARCHITECTURES for s in configs.INPUT_SHAPES
            for m in ("single", "multi")}
    assert set(rows) == want
    bad = {k: v for k, v in rows.items() if v != "ok"}
    assert bad == {("whisper-small", "long_500k", m): "skipped" for m in ("single", "multi")}


def test_sweep_records_roofline_fields():
    ok = [r for r in _sweep() if r["status"] == "ok"]
    assert len(ok) >= 78
    for r in ok:
        for field in ("flops", "flops_by_dtype", "bytes_accessed", "collectives",
                      "collectives_by_axis", "kernel_launches", "compute_s", "memory_s",
                      "collective_s", "dominant", "bound_s", "model_flops_per_chip",
                      "useful_flops_ratio", "peak_memory_in_bytes", "argument_size_in_bytes",
                      "plan_s", "params", "active_params", "variant", "workers"):
            assert field in r, (r["arch"], r["shape"], field)
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert r["workers"] == (32 if r["mesh"] == "multi" else 16)
        if r["shape"] == "train_4k":
            assert r["kernel_launches"].get("median", 0) >= 1, (r["arch"], r["mesh"])


def test_sweep_train_gather_bytes_match_their_closed_form():
    """llama3.2-3b train_4k on the single mesh: the robust gather collects
    every worker's gradient (a rank's bf16 shards, 16 workers) over the
    data axis, one all-gather of 16 x the rank's parameter bytes."""
    rec = next(r for r in _sweep() if (r["arch"], r["shape"], r["mesh"])
               == ("llama3.2-3b", "train_4k", "single"))
    cfg = configs.get_config("llama3.2-3b")
    mesh = mesh_lib.Mesh(("data", "model"), (16, 16), torch.device("meta"), None,
                         per_rank=True)
    rank_bytes = sum(t.numel() * t.element_size() for t in
                     tree_leaves(steps.abstract_params(cfg, mesh)))
    assert rec["collectives_by_axis"]["data"]["all-gather"] == 16 * rank_bytes


def test_report_renders_the_sweep(capsys):
    rows = report.load(JSONL)
    table = report.dryrun_table(rows, "single")
    assert table.count("\n") == 2 + len(configs.ARCHITECTURES) * len(configs.INPUT_SHAPES) - 1
    assert "SKIP" in table and "ERROR" not in table
    report.main(["--in", JSONL])
    out = capsys.readouterr().out
    assert "computed, not measured" in out and "| llama3.2-3b | train_4k |" in out
    assert math.isfinite(sum(r.get("bound_s", 0) for r in rows))


def test_run_combo_is_the_subprocess_plan(plans):
    """``dryrun.run_combo`` (the reference's signature, in its own process,
    the default ``ParallelConfig``) gives the record ``main`` gets from a
    subprocess for the same combo: every field but the planning seconds
    and the subprocess's ``status``."""
    want, got = _ok(plans["production"]), plans["run_combo"]
    assert got["arch"] == "llama3.2-3b" and got["shape"] == "decode_32k"
    drop = ("plan_s", "status")
    assert {k: v for k, v in got.items() if k not in drop} == {
        k: v for k, v in want.items() if k not in drop}
