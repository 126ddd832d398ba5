#!/usr/bin/env python3
"""One dry-run combo's model-axis collectives, bytes by the code that
issued them: what ``launch/dryrun.py`` sums into ``collectives_by_axis``.

    PYTHONPATH=src python3 scripts/gather_breakdown.py \
        [--arch granite-moe-1b-a400m] [--shape train_4k] [--mesh single]
        [--kinds all-gather]

Rank 0's program of the combo runs as ``dryrun.plan`` runs it (a ``fake``
process group of the production mesh, ``meta`` stand-ins, the dry-run's
defaults), under a ``CostMode`` that also files each model-axis
collective of ``--kinds`` under its site: the innermost frame of
``repro_torch/models`` or ``repro_torch/launch`` with its caller's (a
forward collective), or, where none is on the stack (autograd's
backward), the ``core/distributed.py`` function that issued it.  Prints
one JSON object: the combo, the mode's totals by kind on the model axis,
and for each kind its bytes by site, largest first.  Computed on the CPU;
a combo takes about as long as its ``plan_s`` in
``dryrun_torch_results.jsonl``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _site(stack) -> str:
    """The code a collective came from: the innermost model or launch
    frame and its caller, else the innermost ``core/distributed.py``
    function (a backward)."""
    frames = [f for f in stack if "repro_torch" in f.filename]
    model = [f for f in frames if "/models/" in f.filename or "/launch/" in f.filename]
    if model:
        inner = model[-1]
        where = f"{os.path.basename(inner.filename)}:{inner.name}:{inner.lineno}"
        if len(model) > 1:
            where += f" <- {model[-2].name}"
        return where
    dist = [f for f in frames if f.filename.endswith("distributed.py")]
    return f"backward: distributed.py:{dist[-1].name}" if dist else "unknown"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--kinds", default="all-gather",
                    help="comma-separated collective kinds to break down")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.configs import INPUT_SHAPES, ParallelConfig, get_config
    from repro_torch.launch import cost_analysis, dryrun, steps
    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(2)
    kinds = args.kinds.split(",")
    shape = INPUT_SHAPES[args.shape]
    pods, data, model = dryrun.MESHES[args.mesh]
    world = (pods or 1) * data * model
    dryrun.fake_world(world, world // (pods or 1))
    cfg = steps.long_context_cfg(get_config(args.arch), shape)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", remat=True,
                          attn_chunk=1024)  # the dry-run CLI's defaults
    mesh = mesh_lib.make_production_mesh(multi_pod=pods > 0, model=model, device="meta")
    by_site = {k: collections.defaultdict(float) for k in kinds}

    class SiteMode(cost_analysis.CostMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kind = self._kind(func)
            if kind in by_site and self._axis(args) == "model":
                b = float(sum(cost_analysis._nbytes(t) for t in cost_analysis._tensors(args[0])))
                by_site[kind][_site(traceback.extract_stack())] += b
            return super().__torch_dispatch__(func, types, args, kwargs)

    setup, step, _ = dryrun.rank_program(cfg, shape, mesh, pcfg)
    with SiteMode(cost_analysis.group_axes(mesh)) as mode:
        step(setup())
    res = mode.result()
    torch.distributed.destroy_process_group()
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
        "pcfg": dataclasses.asdict(pcfg),
        "model_axis": res["collectives_by_axis"].get("model", {}),
        "by_site": {k: dict(sorted(v.items(), key=lambda kv: -kv[1])) for k, v in
                    by_site.items()},
    }, indent=1))


if __name__ == "__main__":
    main()
