"""The port's public surface against the reference's, by ``ast`` alone (no
import of either package; seconds).

For every module of ``src/repro/`` the port's counterpart under
``src/repro_torch/`` (the same path) must have:
- each public top-level name (function, class, assignment);
- each re-export of an ``__init__.py``;
- each field of a class (annotated class attributes: dataclass fields);
- each public method of a public class;
- each ``add_argument`` flag of its command line.

The three examples pair up the same way (``examples/X.py`` with
``examples/torch_X.py``).  ``JAX_ONLY`` lists every exception, each with
its reason; an exception that the port has after all, or that names
nothing of the reference, fails too, so the list stays exact.
"""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

_SHARDING = "a GSPMD sharding spec (NamedSharding / PartitionSpec); the port runs no shard_map"
_PALLAS = "a Pallas TPU entry point: its Hopper kernel is the wrapper of the same module"
_BACKEND = "picks Pallas or XLA on the TPU; on the card the device picks the kernel"

#: (module path relative to src/repro, kind, name) -> why the port has no counterpart
JAX_ONLY = {
    ("rounds/engine.py", "names", "ScanRunner"):
        "lax.scan segments of a jitted round loop; the port's run_scan loops on the host",
    ("rounds/engine.py", "methods", "ScanRunner.segment"): "ScanRunner's",
    ("rounds/__init__.py", "reexports", "ScanRunner"): "ScanRunner's",
    ("rounds/distributed.py", "names", "shard_map_compat"):
        "a jax.shard_map version shim; the port's programs take a Collectives",
    ("data/pipeline.py", "names", "host_to_mesh"):
        "device_put of a host batch onto a NamedSharding; the port makes the batch on the "
        "mesh's device",
    ("kernels/robust_agg.py", "names", "median_pallas"): _PALLAS,
    ("kernels/robust_agg.py", "names", "trimmed_mean_pallas"): _PALLAS,
    ("kernels/robust_agg.py", "names", "fused_median_trimmed_pallas"): _PALLAS,
    ("kernels/histogram_agg.py", "names", "minmax_pallas"): _PALLAS,
    ("kernels/histogram_agg.py", "names", "histogram_pallas"): _PALLAS,
    ("core/distributed.py", "names", "axis_size"):
        "a named-axis size inside shard_map; the port asks its Collectives (ax.size)",
    ("core/distributed.py", "names", "worker_index"):
        "a named-axis index inside shard_map; the port has launch/mesh.worker_index",
    ("launch/roofline.py", "names", "collective_bytes"):
        "parses collective bytes out of HLO text; the port counts collectives as they run "
        "(cost_analysis.CostMode)",
    ("launch/roofline.py", "names", "ICI_BW"): "the TPU's inter-chip link rate",
    ("launch/roofline.py", "names", "ICI_LINKS"): "the TPU's inter-chip link count",
    ("launch/__init__.py", "reexports", "hlo_analysis"):
        "HLO text analysis; the port's counterpart is launch/cost_analysis",
    ("launch/hlo_analysis.py", "module", ""):
        "HLO text analysis; the port's counterpart is launch/cost_analysis",
    ("fed/run.py", "flags", "--backend"): _BACKEND,
    ("fed/rounds.py", "fields", "RoundConfig.backend"): _BACKEND,
    ("fed/streaming.py", "fields", "SketchConfig.backend"): _BACKEND,
    ("fed/streaming.py", "fields", "SketchConfig.block"): "a Pallas tile width",
    ("fed/streaming.py", "methods", "SketchConfig.use_pallas"): _BACKEND,
    ("attacks/base.py", "fields", "AttackContext.key"):
        "a JAX PRNG key; the port's field is AttackContext.generator (a torch.Generator)",
    ("examples/quickstart.py", "names", "KEY"):
        "a JAX PRNG key; the port's example seeds its generators from SEED",
    ("examples/one_round_federated.py", "names", "KEY"):
        "a JAX PRNG key; the port's example seeds its generators from SEED",
    ("launch/steps.py", "fields", "StepBody.pspec"): _SHARDING,
    ("launch/steps.py", "fields", "StepBody.ospec"): _SHARDING,
    ("launch/steps.py", "fields", "StepBody.batch_spec"): _SHARDING,
    ("launch/steps.py", "fields", "StepBody.comp_spec"): _SHARDING,
    ("models/sharding.py", "fields", "ShardCtx.batch_axes"): _SHARDING,
    ("models/sharding.py", "fields", "ShardCtx.model_axes"): _SHARDING,
    ("models/sharding.py", "fields", "ShardCtx.mesh_shape"): _SHARDING,
    ("models/sharding.py", "fields", "ShardCtx.enable"): _SHARDING,
    ("models/sharding.py", "methods", "ShardCtx.constrain"):
        "with_sharding_constraint; the port's ShardCtx computes on a rank's shards",
    ("serve/engine.py", "methods", "ServeEngine.compile_counts"):
        "jit cache sizes (the no-recompile observable); the port runs eagerly, and its "
        "counterpart is ServeEngine.storage_kept",
}

KINDS = ("names", "reexports", "fields", "methods", "flags")


def surface(source: str, is_init: bool) -> dict:
    """The public surface of one module's source, by kind."""
    tree = ast.parse(source)
    out = {k: set() for k in KINDS}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out["names"].add(node.name)
            if isinstance(node, ast.ClassDef):
                for b in node.body:
                    if (isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                            and not b.name.startswith("_")):
                        out["methods"].add(f"{node.name}.{b.name}")
                    elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                        out["fields"].add(f"{node.name}.{b.target.id}")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(n, ast.Name) and not n.id.startswith("_"):
                        out["names"].add(n.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and is_init:
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                if not name.startswith("_") and name != "annotations":
                    out["reexports"].add(name)
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument":
            out["flags"].update(a.value for a in n.args
                                if isinstance(a, ast.Constant) and isinstance(a.value, str)
                                and a.value.startswith("-"))
    return out


def missing(ref_source: str, port_source: str, is_init: bool) -> dict:
    """{kind: names of the reference's surface the port lacks}."""
    a, b = surface(ref_source, is_init), surface(port_source, is_init)
    return {k: a[k] - b[k] for k in KINDS if a[k] - b[k]}


def pairs():
    """(label, reference path, port path or None): every module of the
    reference, then the examples."""
    for ref in sorted(REF.rglob("*.py")):
        rel = ref.relative_to(REF).as_posix()
        port = PORT / rel
        yield rel, ref, port if port.exists() else None
    for ref in sorted((ROOT / "examples").glob("*.py")):
        if not ref.name.startswith("torch_"):
            port = ref.with_name(f"torch_{ref.name}")
            yield f"examples/{ref.name}", ref, port if port.exists() else None


def gaps() -> set:
    """Every (module, kind, name) of the reference's surface the port lacks."""
    out = set()
    for rel, ref, port in pairs():
        if port is None:
            out.add((rel, "module", ""))
            continue
        for kind, names in missing(ref.read_text(), port.read_text(),
                                   ref.name == "__init__.py").items():
            out.update((rel, kind, n) for n in names)
    return out


def test_the_port_has_the_reference_s_public_surface():
    """Every gap is a listed JAX-only exception, and every listed exception
    is still a gap."""
    found = gaps()
    unexplained = sorted(found - set(JAX_ONLY))
    assert not unexplained, f"the port lacks: {unexplained}"
    stale = sorted(set(JAX_ONLY) - found)
    assert not stale, f"listed as JAX-only but no gap: {stale}"


def test_each_example_has_the_reference_s_flags_plus_device():
    for rel, ref, port in pairs():
        if rel.startswith("examples/"):
            assert port is not None, rel
            a, b = surface(ref.read_text(), False), surface(port.read_text(), False)
            assert b["flags"] == a["flags"] | {"--device"}, rel
            assert "main" in b["names"], rel


def test_a_dropped_name_is_reported():
    """The self-test: a synthetic module pair, each kind dropped once from
    the port's side, is reported under that kind, and nothing else is."""
    ref = '''
import argparse
from pkg.mod import helper
from pkg import sub as alias_name
LIMIT = 3
WIDTH, DEPTH = 1, 2

class Config:
    size: int = 1
    mode: str = "a"

    def build(self):
        return 1

    def _private(self):
        return 2

def run():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int)
    ap.add_argument("--seed")

def _hidden():
    pass
'''
    assert missing(ref, ref, True) == {}
    drops = {
        "names": ("LIMIT = 3\n", "", "LIMIT"),
        "reexports": ("from pkg.mod import helper\n", "", "helper"),
        "fields": ('    mode: str = "a"\n', "", "Config.mode"),
        "methods": ("    def build(self):\n        return 1\n", "", "Config.build"),
        "flags": ('    ap.add_argument("--seed")\n', "", "--seed"),
    }
    for kind, (old, new, name) in drops.items():
        port = ref.replace(old, new)
        assert port != ref, kind
        assert missing(ref, port, True) == {kind: {name}}, kind
    # a tuple target and a whole class are each seen
    assert missing(ref, ref.replace("WIDTH, DEPTH = 1, 2", "WIDTH = 1"), True) == {
        "names": {"DEPTH"}}
    got = missing(ref, ref.replace("class Config:", "class _Config:"), True)
    assert got == {"names": {"Config"}, "fields": {"Config.size", "Config.mode"},
                   "methods": {"Config.build"}}
    # re-exports count only in an __init__
    assert missing(ref, ref.replace("from pkg.mod import helper\n", ""), False) == {}


def test_the_port_s_examples_import_neither_jax_nor_the_reference():
    """examples/torch_*.py import ``torch`` and ``repro_torch`` only."""
    paths = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(paths) == 3
    for path in paths:
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert any(n.startswith("repro_torch") for n in names), path.name
        bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, (path.name, bad)
