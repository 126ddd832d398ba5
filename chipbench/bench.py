"""What every cell shares: finding a cell's files from ``BENCHMARK.json``,
its plain reference module, seeds, the per-layer metric readers, the
import check and the result line.

Nothing here imports the port: a cell's driver (``kinds/<kind>.py``) does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

#: top-level module names no run may hold once its window has closed: JAX and
#: the JAX package the port was ported from (``repro_torch`` starts with
#: ``repro``, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: a name of ``BENCHMARK.json``, and so of a file the harness finds by it
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: the reference module of a configuration file without a ``reference`` key
DEFAULT_REFERENCE = "model"


class CellError(ValueError):
    """A cell, configuration, traffic mix or metric that cannot be run."""


@dataclasses.dataclass
class Cell:
    """One ``workloads`` entry with its files read."""

    name: str
    chips: int
    config: Dict[str, Any]  # the configuration file
    traffic: Dict[str, Any]  # the traffic file
    limits: Dict[str, Any]  # limits/<cell>.json ({} where absent)
    reference: ModuleType  # reference/<the configuration's "reference">.py
    end_to_end: List[Dict[str, Any]]  # the end-to-end metrics this cell reports
    per_layer: List[Dict[str, Any]]  # the per-layer metrics this cell reports
    root: Path  # the checkout: BENCHMARK.json and chipbench/ beneath it


def bench_dir(root: Path) -> Path:
    return Path(root) / "chipbench"


def _load(path: Path, prefix: str, name: str) -> ModuleType:
    """The module of the file ``path``, loaded under a name of its own."""
    mod_name = prefix + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(root: Path, name: str) -> ModuleType:
    """``chipbench/reference/<name>.py`` of the checkout ``root``: a
    configuration's plain model, with the interface that
    :mod:`chipbench.reference` documents."""
    path = bench_dir(root) / "reference" / f"{name}.py"
    if not NAME.match(name) or not path.exists():
        raise CellError(f"no reference module {name!r} at {path}")
    return _load(path, "chipbench_reference_", name)


def _reported(metric: Dict[str, Any], cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and limits files, its configuration's reference module (the
    file's ``reference`` key, :data:`DEFAULT_REFERENCE` without it), and
    the metrics it reports: an end-to-end
    metric without ``workloads`` in every cell, a per-layer metric in the
    cells its ``workloads`` lists (without the key, in every cell that
    reports the end-to-end metric it moves)."""
    root = Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    reference = reference_module(root, config.get("reference", DEFAULT_REFERENCE))
    traffic = json.loads((bench_dir(root) / "traffic" / f"{w['traffic']}.json").read_text())
    lim_path = bench_dir(root) / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reported(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits, reference=reference, end_to_end=e2e, per_layer=per_layer,
                root=root)


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed hashed from the run's ``--seed`` and ``tags`` (ints or
    strings): the weights, the traffic and each of their leaves draw from
    seeds of their own, the same on every run of one seed."""
    h = hashlib.blake2b(repr((int(seed),) + tuple(tags)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


# ---------------------------------------------------------------------------
# per-layer metric readers
# ---------------------------------------------------------------------------


def metric_reader(root: Path, name: str) -> Callable[[Any], Optional[float]]:
    """``read(trace) -> value or None`` of ``chipbench/metrics/<name>.py``.
    A missing file is an error: a metric the benchmark names is read."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    if not path.exists():
        raise CellError(f"per-layer metric {name!r} has no reader at {path}")
    return _load(path, "chipbench_metric_", name).read


def read_per_layer(cell: Cell, trace) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell its reader finds something to read
    for; a reader returning None leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(cell.root, m["name"])(trace)
        if value is not None:
            if not math.isfinite(value):
                raise CellError(f"metric {m['name']} read {value}")
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the import check and the result line
# ---------------------------------------------------------------------------


def forbidden_modules(modules=None) -> List[str]:
    """The names in ``sys.modules`` whose top-level name is one of
    :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN)


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    """One line per number compared: its name, its reading and its limit."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}" for k, v in checks.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Any],
                device: Dict[str, Any], checks: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The last line of standard output, with the numbers compared under
    ``checks``, which comes last."""
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
