"""Runs that have to come out not correct, on the CPU at smoke sizes: the
control (the reference put in the program's place, its products in
float8) and each fault a training cell can have, planted under the timed
path of an otherwise whole run.  The limits here are the smoke sizes'
own, set between the sound runs' readings and the control's on this CPU;
the cells' limits on the card are in ``limits/``."""
from __future__ import annotations

import importlib
import json
import time
from pathlib import Path

import pytest
import torch

from chipbench import bench, faults, generate
from chipbench.kinds import train
from chipbench.reference import train as reference

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
#: at these sizes on this CPU sound runs read loss <= 2.3e-5, grad1 <=
#: 1.3e-3 (7 seeds a cell), the control loss >= 1.05e-4, grad1 >= 3.6e-3
#: (4 seeds), the faults grad1 >= 0.36
SMOKE_LIMITS = {"loss": 5e-5, "grad1": 2.5e-3}
SEED = 2 ** 31 + 3


def smoke_cell(name: str) -> bench.Cell:
    cell = bench.load_cell(ROOT, name)
    cell.config["port"].update(cell.config["smoke"])
    cell.traffic.update(batch_per_worker=2, seq_len=32)
    return cell


def run(cell: bench.Cell) -> dict:
    """One run of ``cell`` through the driver of its traffic's ``kind``."""
    driver = importlib.import_module(f"chipbench.kinds.{cell.traffic['kind']}")
    return driver.run(cell, SEED, 0.05, False, torch.device("cpu"), time.perf_counter(),
                      SMOKE_LIMITS)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(name):
    cell = smoke_cell(name)
    out = run(cell)
    assert out["correct"], out["checks"]
    ref = out["readings"]["reference"]
    ring = generate.make_ring(cell.traffic, cell.config["port"]["vocab"], SEED, "cpu")
    control = train.reference_readings(cell, SEED, ring, cell.traffic["check_steps"], "cpu",
                                       cell.reference.fp8_matmul)
    checks = train.judge(reference.gaps(control, ref), SMOKE_LIMITS, name)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    cell = smoke_cell(name)
    with faults.planted(fault):
        out = run(cell)
    assert not out["correct"], out["checks"]
