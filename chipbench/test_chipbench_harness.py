"""The harness on the CPU at each configuration's smoke sizes: a run's
result line, the names and units of ``BENCHMARK.json``, the port's config
built from a configuration file, cells made of new files only, and the
import check."""
from __future__ import annotations

import importlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from chipbench import bench
from chipbench.kinds import port_config, train

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LOOSE = {"loss": 1e-2, "grad1": 5e-2, "delta": 5e-2}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def smoke_cell(root: Path, name: str) -> bench.Cell:
    """The cell ``name`` at its configuration's smoke sizes, 16-token rows."""
    cell = bench.load_cell(root, name)
    cell.config["port"].update(cell.config["smoke"])
    cell.traffic.update(batch_per_worker=2, seq_len=16)
    return cell


def run_smoke(cell: bench.Cell, trace: bool, seed: int = 2 ** 31 + 77, limits=LOOSE):
    """One run of ``cell`` through the driver of its traffic's ``kind``, as
    ``run.py`` dispatches it."""
    driver = importlib.import_module(f"chipbench.kinds.{cell.traffic['kind']}")
    return driver.run(cell, seed, 0.2, trace, torch.device("cpu"), time.perf_counter(), limits)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_smoke_run(workload, trace):
    cell = smoke_cell(ROOT, workload)
    out = run_smoke(cell, trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == set(LOOSE)
    if trace:
        # the host-clock spans read on the CPU; the device's metrics do not
        assert {"worker_grads_ms", "attack_ms", "aggregate_ms", "update_ms"} <= set(out["metrics"])
        device = {m["name"] for m in SPEC["per_layer"] if m["source"] != "host_clock"}
        assert not device & set(out["metrics"])
        assert {"busy_s", "window_s"} <= set(out["device"])
        # the program's spans and counters were on in the profiled steps
        profile = out["trace"].profile
        calls = {r[0]: r[1] for r in profile["spans"]}
        assert calls["step"] == 2 and calls["worker.grads"] == 2
        assert profile["counts"]["attn.scores"] > profile["counts"]["attn.kept"] > 0
        assert ("moe.pairs" in profile["counts"]) == ("moe" in cell.config["port"])
        assert {"spans", "idle_spans"} <= set(out["breakdown"])
    else:
        assert set(out["metrics"]) == {m["name"] for m in SPEC["end_to_end"]}
        assert out["metrics"]["train_tokens_per_s"]["value"] > 0


def test_result_line_keys_and_order():
    checks = {"grad1": {"value": 1e-4, "limit": 1e-3}}
    line = bench.result_line(True, 3, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                             {"platform": "gpu", "kind": "x", "count": 1,
                              "memory_peak_bytes": 1}, checks,
                             {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert bench.check_lines(checks) == ["check grad1: 0.0001 limit 0.001 ok"]


def test_benchmark_names_units_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in SPEC["paths"])
    assert 1 <= SPEC["run_seconds"] <= 51
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).exists() and c["file"].startswith("chipbench/")
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (ROOT / "chipbench" / "limits" / f"{w['name']}.json").exists()
        names.append(w["name"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (ROOT / "chipbench" / "metrics" / f"{m['name']}.py").exists()
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))


def _as_file(value, given):
    """A port config field as a configuration file gives it: a nested
    dataclass as a dict of the keys the file gives, a tuple as a list."""
    if isinstance(given, dict):
        return {k: _as_file(getattr(value, k), v) for k, v in given.items()}
    return list(value) if isinstance(value, tuple) else value


def test_configs_are_the_ports_published_ones():
    from repro_torch.configs import get_config

    for c in SPEC["configs"]:
        port = json.loads((ROOT / c["file"]).read_text())["port"]
        cfg, built = get_config(port["name"]), port_config(port)
        for k, v in port.items():
            assert _as_file(getattr(cfg, k), v) == v, (c["name"], k)
            assert getattr(built, k) == getattr(cfg, k), (c["name"], k)


def test_port_config_builds_nested_groups_and_refuses_unknown_keys():
    from repro_torch.configs.base import SSMConfig

    port = {"name": "h", "family": "hybrid", "n_layers": 4, "d_model": 64, "n_heads": 4,
            "n_kv_heads": 2, "d_ff": 0, "vocab": 32, "ssm": {"d_state": 16, "head_dim": 16},
            "hybrid_pattern": ["ssm", "ssm", "attn"]}
    cfg = port_config(port)
    assert cfg.ssm == SSMConfig(d_state=16, head_dim=16) and cfg.moe is None
    assert cfg.hybrid_pattern == ("ssm", "ssm", "attn")
    assert [cfg.layer_kind(i) for i in range(4)] == ["ssm", "ssm", "attn", "ssm"]
    with pytest.raises(bench.CellError, match="shared_expert"):
        port_config(dict(port, shared_expert=8))
    with pytest.raises(bench.CellError, match="groups"):
        port_config(dict(port, ssm={"d_state": 16, "groups": 1}))


def _add_cell(root: Path, cell: str, config: dict, traffic: str) -> dict:
    """A copy of the benchmark at ``root`` with the configuration ``config``
    and the cell ``cell`` on ``traffic`` added as new files and entries
    (the cell's limits LOOSE); the new ``BENCHMARK.json`` still unwritten."""
    if not (root / "chipbench").exists():
        shutil.copytree(ROOT / "chipbench", root / "chipbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    (root / f"chipbench/configs/{config['name']}.json").write_text(json.dumps(config))
    (root / f"chipbench/limits/{cell}.json").write_text(json.dumps({"limits": LOOSE}))
    spec["configs"].append({"name": config["name"], "source": "test",
                            "file": f"chipbench/configs/{config['name']}.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": cell, "config": config["name"], "traffic": traffic,
                              "chips": 1, "why": "test"})
    return spec


def test_new_files_make_a_runnable_cell(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, nothing edited, run as a cell of their own."""
    cfg = json.loads((ROOT / "chipbench/configs/danube-1.8b.json").read_text())
    cfg["name"] = "tiny-dense"
    cfg["port"].update(cfg.pop("smoke"), name="tiny-dense", sliding_window=8)
    cell = "tiny-dense.train.trimmed-flip.m3"
    spec = _add_cell(tmp_path, cell, cfg, "trimmed-flip.m3")
    mix = json.loads((ROOT / "chipbench/traffic/median-alie.m4.json").read_text())
    mix.update(workers=3, batch_per_worker=1, seq_len=24,
               agg={"method": "trimmed_mean", "beta": 0.34, "strategy": "gather"},
               attack={"name": "label_flip", "alpha": 0.3})
    (tmp_path / "chipbench/traffic/trimmed-flip.m3.json").write_text(json.dumps(mix))
    (tmp_path / "chipbench/metrics/steps_spanned.py").write_text(
        "def read(t):\n    return float(len(t.spans.get('step', []))) or None\n")
    spec["per_layer"].append({"name": "steps_spanned", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "step body",
                              "moves": "train_tokens_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    loaded = bench.load_cell(tmp_path, cell)
    out = train.run(loaded, 5, 0.2, True, torch.device("cpu"), time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["steps_spanned"]["value"] == 2.0


#: a test's own reference module: the port's hybrid family with a period of
#: one attention layer is the dense decoder with a local window, so this
#: module hands model.py's mathematics that decoder and records each call
_LOCAL_REFERENCE = '''
from chipbench.reference import model as M

CALLS = []
matmul, fp8_matmul = M.matmul, M.fp8_matmul


def _dense(model):
    return dict(model, family="dense", sliding_window=model["local_window"])


def param_specs(model):
    CALLS.append("param_specs")
    return M.param_specs(_dense(model))


def loss(leaves, tokens, labels, model, mm=matmul):
    CALLS.append("loss")
    return M.loss(leaves, tokens, labels, _dense(model), mm)


def model_flops_per_step(model, traffic):
    CALLS.append("model_flops_per_step")
    return M.model_flops_per_step(_dense(model), traffic)
'''


@pytest.mark.parametrize("trace", [False, True])
def test_a_configuration_brings_its_own_reference(tmp_path, trace):
    """A configuration of a family ``model.py`` refuses, with its reference
    module, port config and cell as new files and entries, nothing edited,
    runs as a cell through its own module."""
    from chipbench.reference import model as M

    port = {"name": "tiny-local", "family": "hybrid", "n_layers": 2, "d_model": 128,
            "n_heads": 8, "n_kv_heads": 2, "d_ff": 256, "vocab": 256, "rope_theta": 10000.0,
            "norm_eps": 1e-5, "dtype": "bfloat16", "hybrid_pattern": ["attn"],
            "local_window": 8}
    with pytest.raises(ValueError, match="hybrid"):
        M.param_specs(port)
    cell = "tiny-local.train.median-alie.m4"
    spec = _add_cell(tmp_path, cell, {"name": "tiny-local", "reference": "tiny_local",
                                      "port": port}, "median-alie.m4")
    (tmp_path / "chipbench/reference/tiny_local.py").write_text(_LOCAL_REFERENCE)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    loaded = bench.load_cell(tmp_path, cell)
    assert loaded.reference.__file__ == str(tmp_path / "chipbench/reference/tiny_local.py")
    loaded.traffic.update(batch_per_worker=2, seq_len=16)
    out = run_smoke(loaded, trace, limits=None)
    assert out["correct"] and set(out["checks"]) == set(LOOSE)
    calls = set(loaded.reference.CALLS)
    assert {"param_specs", "loss"} <= calls
    assert ("model_flops_per_step" in calls) == trace


def test_forbidden_modules_compare_whole_names():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1, "reprox": 1}
    assert bench.forbidden_modules(mods) == []
    mods.update({"repro.core.aggregators": 1, "jaxlib": 1, "flax.linen": 1})
    assert bench.forbidden_modules(mods) == ["flax.linen", "jaxlib", "repro.core.aggregators"]


_IMPORTS = """
import sys, time, json
sys.path[:0] = [{root!r}, {root!r} + '/src']
import torch
from chipbench import bench
from chipbench.reference import model, robust, train as ref
assert not [m for m in sys.modules if m.split('.')[0] == 'repro_torch'], 'reference'
from chipbench.kinds import train
cell = bench.load_cell({root!r}, {cell!r})
cell.config['port'].update(cell.config['smoke'])
cell.traffic.update(batch_per_worker=1, seq_len=8)
train.run(cell, 3, 0.05, True, torch.device('cpu'), time.perf_counter(),
          {{'loss': 1.0, 'grad1': 1.0, 'delta': 1.0}})
print(json.dumps(bench.forbidden_modules()))
"""


def test_a_run_loads_neither_jax_nor_the_reference_package():
    cell = SPEC["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "-c", _IMPORTS.format(root=str(ROOT), cell=cell)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this holds the refusal without one")
    out = subprocess.run([sys.executable, str(ROOT / "chipbench/run.py"), "--workload",
                          SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
