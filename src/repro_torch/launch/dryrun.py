"""Dry-run: plan every (arch × shape × mesh) combo on one rank, with no card
(the reference's ``repro.launch.dryrun``).

The reference lowers and compiles each step on 512 placeholder devices and
reads XLA's memory and cost analyses.  The port's counterpart runs rank
0's whole program at production width on ``meta`` tensors (shapes and
dtypes, no memory, no kernel: the kernel ops' fake implementations give
their outputs' shapes) under one
:class:`~repro_torch.launch.cost_analysis.CostMode`, in a process whose
``torch.distributed`` group is a ``fake`` group of 256 (single: data 16 ×
model 16) or 512 ranks (multi: pod 2 × data 16 × model 16), so
:func:`~repro_torch.launch.mesh.make_production_mesh` lays out the
reference's mesh and every collective runs its code and moves nothing.
Meta rather than ``FakeTensorMode``'s fake CUDA tensors: on a CPU-only
torch the autograd engine opens a CUDA device guard for a fake CUDA
tensor's backward, which such a build lacks (the process aborts), and a
meta tensor runs the same ops on either build.  A sharding mismatch, a
data-dependent host read or a missing kernel registration fails here.
Each combo runs in a subprocess of its own (a process has one default
group) and emits one JSON record: its memory (``argument_size_in_bytes``,
``peak_memory_in_bytes``), its counts (``flops``, ``flops_by_dtype``,
``bytes_accessed``, ``collectives``, ``collectives_by_axis``,
``kernel_launches``) and the H100 roofline of them
(:mod:`repro_torch.launch.roofline`, computed from the data sheet, not
measured).  The reference's ``compile_s`` is ``plan_s`` here, its
``xla_*`` fields have no counterpart.

Where the kv heads do not divide the model axis but the reference's
``_ok`` splits them unevenly (GSPMD pads), each rank attends with its
ceil(kv / M) kv heads, the last ranks with fewer or none (``padded`` mode,
:mod:`repro_torch.models.sharding`); its caches hold those heads, where
the reference's cache spec falls to the head dim (ROADMAP queue C).  Where
the reference replicates the kv heads (``2·kv < M``) the port computes
attention from gathered leaves and keeps the caches whole.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --out dryrun_torch_results.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Tuple

import torch

from repro_torch.configs import (ARCHITECTURES, INPUT_SHAPES, ParallelConfig, ShapeConfig,
                                 get_config, get_smoke_config)
from repro_torch.core.attacks import AttackConfig
from repro_torch.launch import cost_analysis, roofline, steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.tree import tree_map

# long_500k applicability (the reference's DESIGN.md §Input-shape handling):
# mamba2, recurrentgemma and h2o-danube are sub-quadratic natively; the
# dense, MoE and VLM configs run the sliding-window variant; whisper-small
# (an encoder-decoder audio model with a bounded decoder context) is skipped.
SKIP = {("whisper-small", "long_500k"): "enc-dec audio model; 500k-token decode has no meaning"}

#: the production meshes: (pods, data, model)
MESHES = {"single": (0, 16, 16), "multi": (2, 16, 16)}


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------


def fake_world(world: int, local_world: int) -> None:
    """Join a ``fake`` process group of ``world`` ranks as rank 0, hosts of
    ``local_world`` ranks (``LOCAL_WORLD_SIZE``, which lays out the multi
    mesh's pods)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    os.environ["LOCAL_RANK"] = "0"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@contextlib.contextmanager
def fake_group(sizes: Tuple[int, int, int]):
    """This process as rank 0 of the fake group of a (pods, data, model)
    mesh for the ``with`` block, the group destroyed after it."""
    pods, data, model = sizes
    world = (pods or 1) * data * model
    fake_world(world, world // (pods or 1))
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# a rank's program
# ---------------------------------------------------------------------------


def _zeros(tree, device):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), tree)


def _rank_rows(meta: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """A stand-in cut to this rank's block of the worker axes where its spec
    splits a dim over them (the batch rows a rank serves)."""
    waxes = mesh_lib.worker_axes(mesh)
    entry = waxes if len(waxes) > 1 else waxes[0]
    m = mesh_lib.num_workers(mesh)
    for d, e in enumerate(spec):
        if e == entry and m > 1:
            return meta.chunk(m, d)[mesh_lib.worker_index(mesh)]
    return meta


def rank_program(cfg, shape: ShapeConfig, mesh, pcfg: ParallelConfig, optimizer: str = "adamw",
                 device_steps: int = 1) -> Tuple[Callable, Callable, int]:
    """``(setup, step, tokens)``: ``setup()`` makes the step's arguments on
    the mesh's device as this rank holds them (params and optimizer state,
    the inputs; zeros), ``step(args)`` runs the step once, exactly as the
    reference lowers it: ``make_train_step``, ``trainer.make_window_step``
    for ``device_steps > 1``, ``make_prefill_step`` or
    ``make_decode_step``; ``tokens`` are the tokens the step processes
    (the whole mesh's)."""
    dev = mesh.device
    fsdp = pcfg.param_mode == "fsdp" and shape.kind == "train"
    params_meta = (steps.abstract_params_fsdp(cfg, mesh) if fsdp
                   else steps.abstract_params(cfg, mesh))
    inputs = steps.input_specs(cfg, shape, mesh)
    attack = AttackConfig("none", 0.0)
    if shape.kind == "train" and device_steps > 1:
        from repro_torch.launch import trainer

        opt = get_optimizer(optimizer, 1e-4)
        fn = trainer.make_window_step(cfg, pcfg, mesh, opt, attack=attack,
                                      device_steps=device_steps)
        state_meta = trainer.abstract_state(cfg, mesh, opt, pcfg=pcfg)
        batch_meta = trainer.abstract_window_batches(cfg, shape, mesh, device_steps)

        def setup():  # the step and the attack key are host scalars (init_state's)
            state = dict(_zeros(state_meta, dev), step=torch.zeros((), dtype=torch.int64),
                         key=torch.zeros((), dtype=torch.int64))
            return state, {k: _zeros(v.meta, dev) for k, v in batch_meta.items()}

        return setup, lambda args: fn(*args), shape.global_batch * shape.seq_len * device_steps
    if shape.kind == "train":
        opt = get_optimizer(optimizer, 1e-4)
        fn = steps.make_train_step(cfg, pcfg, mesh, opt, attack=attack)

        def setup():
            params = _zeros(params_meta, dev)
            return params, opt.init(params), {k: _zeros(v.meta, dev) for k, v in inputs.items()}

        return setup, lambda args: fn(*args, 0), shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg, kv_block=pcfg.attn_chunk, mesh=mesh)

        def setup():
            args = [_zeros(params_meta, dev), _zeros(inputs["tokens"].meta, dev)]
            if "frontend" in inputs:
                args.append(_zeros(inputs["frontend"].meta, dev))
            return args

        return setup, lambda args: fn(*args), shape.global_batch * shape.seq_len
    fn = steps.make_decode_step(cfg, mesh)
    cache = tree_map(lambda s: s.meta, inputs["cache"])
    specs = tree_map(lambda s: s.spec, inputs["cache"])
    model = mesh_lib.model_size(mesh)
    if mesh.per_rank and model > 1:
        cache = sharding.shard_cache(cache, sharding.cache_dims(cfg, model, cache, specs),
                                     mesh_lib.model_rank(mesh), model)
    if mesh.per_rank:
        cache = tree_map(lambda t, s: _rank_rows(t, s, mesh), cache, specs)
        token = _rank_rows(inputs["token"].meta, inputs["token"].spec, mesh)
    else:
        token = inputs["token"].meta

    def setup():
        return (_zeros(params_meta, dev), _zeros(token, dev), _zeros(cache, dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    return setup, lambda args: fn(*args), shape.global_batch


def plan(cfg, shape: ShapeConfig, mesh, pcfg: ParallelConfig, optimizer: str = "adamw",
         device_steps: int = 1) -> Tuple[dict, int]:
    """Rank 0's program on ``mesh``'s device under :class:`CostMode` -> (the
    counts with ``argument_bytes``, the step's tokens)."""
    setup, step, tokens = rank_program(cfg, shape, mesh, pcfg, optimizer, device_steps)
    with cost_analysis.CostMode(cost_analysis.group_axes(mesh)) as mode:
        args = setup()
        arg_bytes = mode.live
        step(args)
    res = mode.result()
    res["argument_bytes"] = arg_bytes
    return res, tokens


def record(arch: str, shape_name: str, mesh_kind: str, pcfg: ParallelConfig, cfg, shape,
           sizes: Tuple[int, int, int], optimizer: str, device_steps: int) -> dict:
    """Plan one combo in this process (its fake group joined, see
    :func:`run_child`) -> the JSON record."""
    pods, data, model = sizes
    chips = (pods or 1) * data * model
    t0 = time.time()
    mesh = mesh_lib.make_production_mesh(multi_pod=pods > 0, model=model, device="meta")
    res, tokens = plan(cfg, shape, mesh, pcfg, optimizer, device_steps)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "strategy": pcfg.agg_strategy, "agg": pcfg.agg_method,
        "param_mode": pcfg.param_mode, "attn_chunk": pcfg.attn_chunk,
        "seq_parallel": pcfg.seq_parallel, "remat": pcfg.remat,
        "workers": mesh_lib.num_workers(mesh), "mesh_shape": mesh_lib.mesh_shape_dict(mesh),
        "params": T.count_params(cfg), "active_params": T.count_active_params(cfg),
        "variant": cfg.name, "device_steps": device_steps,
        "plan_s": round(time.time() - t0, 1),
        "argument_size_in_bytes": int(res["argument_bytes"]),
        "peak_memory_in_bytes": int(res["peak_bytes"]),
        "flops": res["flops"], "flops_by_dtype": res["flops_by_dtype"],
        "bytes_accessed": res["bytes"],
        "collectives": dict(res["collectives"], total=res["collective_bytes"]),
        "collectives_by_axis": res["collectives_by_axis"],
        "kernel_launches": res["kernel_launches"],
    }
    links = roofline.axis_links(rec["mesh_shape"])
    rec["links"] = {a: links.get(a, roofline.NET_BW) for a in rec["collectives_by_axis"]}
    wire = {a: cost_analysis.wire_bytes(c) for a, c in rec["collectives_by_axis"].items()}
    rec.update(roofline.roofline_terms(rec["flops_by_dtype"], rec["bytes_accessed"], wire,
                                       links=rec["links"]))
    mf = roofline.model_flops(rec["active_params"], tokens, shape.kind)
    rec["model_flops_global"] = mf
    rec["model_flops_per_chip"] = mf / chips
    rec["useful_flops_ratio"] = rec["model_flops_per_chip"] / rec["flops"] if rec["flops"] else 0.0
    return rec


def run_combo(arch: str, shape_name: str, mesh_kind: str, pcfg: ParallelConfig,
              optimizer: str = "adamw", device_steps: int = 1) -> dict:
    """Plan one (arch × shape × mesh) combo at published widths in THIS
    process -> its record (:func:`record`): the process joins the fake
    group of ``mesh_kind``'s production mesh for the call and leaves it
    after, so it must hold no other default group.  ``main`` plans each
    combo in a subprocess instead (:func:`plan_in_subprocess`)."""
    sizes = MESHES[mesh_kind]
    shape = INPUT_SHAPES[shape_name]
    cfg = steps.long_context_cfg(get_config(arch), shape)
    with fake_group(sizes):
        return record(arch, shape_name, mesh_kind, pcfg, cfg, shape, sizes, optimizer,
                      device_steps)


# ---------------------------------------------------------------------------
# a combo in a subprocess
# ---------------------------------------------------------------------------


def real_step(cfg, shape: ShapeConfig, mesh, pcfg: ParallelConfig, optimizer: str = "adamw",
              device_steps: int = 1) -> dict:
    """Rank 0's program (:func:`rank_program`) once on the card's real
    tensors over ``mesh`` (under the fake group the collectives move no
    data, so its values mean nothing): the step's seconds (synchronized),
    the peak of ``torch.cuda.max_memory_allocated`` from the setup on,
    and the kernel launches of the step."""
    from repro_torch.kernels import histogram_agg, robust_agg

    setup, step, _ = rank_program(cfg, shape, mesh, pcfg, optimizer, device_steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    args = setup()
    torch.cuda.synchronize()
    robust_agg.reset_launches()
    histogram_agg.reset_launches()
    t0 = time.perf_counter()
    step(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in {**robust_agg.LAUNCHES, **histogram_agg.LAUNCHES}.items() if v}
    return {"step_s": seconds, "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "kernel_launches": launches}


def run_child(spec: dict) -> dict:
    """The child's work: join the fake group of ``spec``'s mesh and plan.
    ``spec``: arch, shape (a name or [name, seq_len, global_batch, kind]),
    mesh (``single`` / ``multi``), sizes [pods, data, model] (default the
    production mesh's), smoke (the smoke config), over (ModelConfig
    overrides), pcfg (ParallelConfig fields), optimizer, device_steps;
    ``real``: run the program on the card instead (:func:`real_step`)."""
    torch.set_num_threads(2)  # several children plan at once
    arch = spec["arch"]
    shp = spec["shape"]
    shape = INPUT_SHAPES[shp] if isinstance(shp, str) else ShapeConfig(*shp)
    pods, data, model = spec.get("sizes") or MESHES[spec["mesh"]]
    cfg = (get_smoke_config if spec.get("smoke") else get_config)(arch)
    cfg = steps.long_context_cfg(dataclasses.replace(cfg, **spec.get("over", {})), shape)
    pcfg = ParallelConfig(**spec.get("pcfg", {}))
    with fake_group((pods, data, model)):
        if spec.get("real"):
            mesh = mesh_lib.make_production_mesh(multi_pod=pods > 0, model=model,
                                                 device="cuda")
            return real_step(cfg, shape, mesh, pcfg, spec.get("optimizer", "adamw"),
                             spec.get("device_steps", 1))
        return record(arch, shape.name, spec["mesh"], pcfg, cfg, shape, (pods, data, model),
                      spec.get("optimizer", "adamw"), spec.get("device_steps", 1))


def plan_in_subprocess(spec, timeout: float = 3600):
    """One combo in a fresh process (``python -m repro_torch.launch.dryrun
    --child SPEC``): its record, or an ``error`` record with the child's
    output tail.  A list of specs is planned in one process, one after the
    other, each under its own fake group (the tests' small meshes); the
    records come back as a list."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("OMP_NUM_THREADS", "2")
    try:
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--child",
                            json.dumps(spec)], capture_output=True, text=True, env=env,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"status": "error", "error": f"TimeoutExpired: {timeout} s"}
    recs = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    want = len(spec) if isinstance(spec, list) else 1
    if r.returncode or len(recs) != want:
        recs += [{"status": "error", "error": f"child exit {r.returncode}",
                  "trace": (r.stdout + r.stderr)[-2000:]}] * (want - len(recs))
    return recs[:want] if isinstance(spec, list) else recs[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true", help="run every combo on both meshes")
    ap.add_argument("--strategy", default="gather",
                    choices=["gather", "bucketed", "hierarchical", "chunked", "psum"])
    ap.add_argument("--device-steps", type=int, default=1,
                    help="plan the trainer's device-steps window instead of the single "
                         "train step (train shapes)")
    ap.add_argument("--param-mode", default="replicated", choices=["replicated", "fsdp"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--agg", default="median",
                    choices=["mean", "median", "trimmed_mean",
                             "approx_median", "approx_trimmed_mean"])
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--remat", type=int, default=1)
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combos planned at once (each in its own process)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child is not None:  # combos in this process, a fake group each
        specs = json.loads(args.child)
        for spec in specs if isinstance(specs, list) else [specs]:
            try:
                rec = run_child(spec)
                rec["status"] = "ok"
            except Exception as e:  # noqa: BLE001 — report, the parent keeps going
                rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            print(json.dumps(rec), flush=True)
        return 0

    pcfg = ParallelConfig(agg_method=args.agg, agg_strategy=args.strategy,
                          param_mode=args.param_mode, seq_parallel=args.seq_parallel,
                          remat=bool(args.remat), attn_chunk=args.attn_chunk)
    if args.all:
        combos = [(a, s, m) for a in ARCHITECTURES for s in INPUT_SHAPES
                  for m in ("single", "multi")]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all) required"
        combos = [(args.arch, args.shape, args.mesh)]

    # resume: skip combos already recorded (ok/skipped) in --out
    def key(arch, shape, mesh):
        return (arch, shape, mesh, args.strategy, args.agg, args.param_mode,
                args.attn_chunk, args.seq_parallel, args.device_steps)

    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"], r.get("strategy", "gather"),
                              r.get("agg", "median"), r.get("param_mode", "replicated"),
                              r.get("attn_chunk", 1024), r.get("seq_parallel", False),
                              r.get("device_steps", 1)))
    combos = [c for c in combos if key(*c) not in done]
    print(f"# {len(combos)} combos to run ({len(done)} already done)", flush=True)

    def one(combo):
        arch, shape, mesh = combo
        if (arch, shape) in SKIP:
            return {"arch": arch, "shape": shape, "mesh": mesh, "status": "skipped",
                    "reason": SKIP[(arch, shape)]}
        rec = plan_in_subprocess({"arch": arch, "shape": shape, "mesh": mesh,
                                  "pcfg": dataclasses.asdict(pcfg),
                                  "optimizer": args.optimizer,
                                  "device_steps": args.device_steps})
        return rec if rec.get("status") == "ok" else dict(rec, arch=arch, shape=shape,
                                                          mesh=mesh)

    ok = True
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:  # records in combo order
        for rec in pool.map(one, combos):
            ok = ok and rec["status"] != "error"
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
