"""The harness on the CPU at each configuration's smoke sizes: a run's
result line, the names and units of ``BENCHMARK.json``, a cell made of new
files only, and the import check."""
from __future__ import annotations

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
from chipbench.kinds import train

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
    return train.run(cell, seed, 0.2, trace, torch.device("cpu"), time.perf_counter(), limits)


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
        assert not {"idle_share", "train_mfu", "agg_kernel_roofline"} & set(out["metrics"])
        assert {"busy_s", "window_s"} <= set(out["device"])
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


def test_configs_are_the_ports_published_ones():
    from repro_torch.configs import get_config

    for c in SPEC["configs"]:
        port = json.loads((ROOT / c["file"]).read_text())["port"]
        cfg = get_config(port["name"])
        for k, v in port.items():
            got = getattr(cfg, k)
            assert (vars(got) if k == "moe" else got) == v, (c["name"], k)


def test_new_files_make_a_runnable_cell(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries, nothing edited, run as a cell of their own."""
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((ROOT / "chipbench/configs/danube-1.8b.json").read_text())
    cfg["name"] = "tiny-dense"
    cfg["port"].update(cfg.pop("smoke"), name="tiny-dense", sliding_window=8)
    (tmp_path / "chipbench/configs/tiny-dense.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "chipbench/traffic/median-alie.m4.json").read_text())
    mix.update(workers=3, batch_per_worker=1, seq_len=24,
               agg={"method": "trimmed_mean", "beta": 0.34, "strategy": "gather"},
               attack={"name": "label_flip", "alpha": 0.3})
    (tmp_path / "chipbench/traffic/trimmed-flip.m3.json").write_text(json.dumps(mix))
    (tmp_path / "chipbench/metrics/steps_spanned.py").write_text(
        "def read(t):\n    return float(len(t.spans.get('step', []))) or None\n")
    cell = "tiny-dense.train.trimmed-flip.m3"
    (tmp_path / f"chipbench/limits/{cell}.json").write_text(json.dumps({"limits": LOOSE}))
    spec["configs"].append({"name": "tiny-dense", "source": "test",
                            "file": "chipbench/configs/tiny-dense.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": cell, "config": "tiny-dense",
                              "traffic": "trimmed-flip.m3", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "steps_spanned", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "step body",
                              "moves": "train_tokens_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    loaded = bench.load_cell(tmp_path, cell)
    out = train.run(loaded, 5, 0.2, True, torch.device("cpu"), time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["steps_spanned"]["value"] == 2.0


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
