#!/usr/bin/env python3
"""What the bitwise contracts of fsdp x TP, sequence parallelism and the
codecs on the model axis cost on one CUDA card.

    python3 scripts/step7_costs.py --part norm [--src DIR] [--runs plain,sp]
                                   [--steps 6] [--tag NAME]
    python3 scripts/step7_costs.py --part sketch [--steps 3]

``--part norm`` times the model-2 train step of ``chip_smoke.py`` phase
20b's cell (llama3.2-3b widths, 8 layers, bf16, make_debug_mesh(4, 2),
m = 4, batch 8, seq 128, gather median beta 0.25 under ALIE alpha 0.25,
AdamW 1e-4, remat off) with the ``repro_torch`` package of the tree
``--src`` (default this checkout's ``src``): each entry of ``--runs`` is
``plain`` (no sequence parallelism) or ``sp`` (``seq_parallel``), two
warm-up steps, then ``--steps`` steps each closed by a synchronize, then
one profiled step (kernel launches, the device's busy share).  Give it
two trees in turn (parent, change, change, parent) to compare them within
one call; the losses say whether the trees compute the same bits.

``--part sketch`` (this checkout): the count sketch of one worker's
message at phase 23c's size (llama3.2-3b at 2 layers, D = 989,346,816
f32 coordinates, width D / 2, one rotated map) accumulated by
``index_add_`` (atomics) and by ``compression.sketch_accumulate`` (the
card's sorted ``index_put_``), each twice, with whether each is bitwise
its own rerun and whether the card's sorted sum is bitwise the CPU's
``index_add_`` on a 2^22-coordinate row; then phase 23c's count_sketch
step at make_debug_mesh(4, 2) with each accumulation, alternated.

Every reading is one JSON line; the last two lines are the card's name
and power limit and ``done``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKERS, MODEL, LR, BETA, ALPHA = 4, 2, 1e-4, 0.25, 0.25
DATA = dict(seq_len=128, global_batch=8, num_workers=WORKERS, seed=0)
LAYERS = {"norm": 8, "sketch": 2}
WARM = 2


def _setup(cfg_layers: int, compression: str = "none", seq_parallel: bool = False):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("llama3_2_3b"), n_layers=cfg_layers)
    mesh = mesh_lib.make_debug_mesh(WORKERS, MODEL, device=dev)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=BETA,
                          remat=False, attn_chunk=0, seq_parallel=seq_parallel,
                          compression=compression)
    return cfg, mesh, pcfg, AttackConfig("alie", ALPHA), DataConfig(vocab=cfg.vocab, **DATA)


def _timed_steps(cfg, mesh, pcfg, atk, dcfg, n: int, profile: bool):
    """WARM + n steps from seeded params: each timed step's ms and every
    step's loss; with ``profile`` one more step traced."""
    import torch

    from repro_torch.launch import steps, trainer
    from repro_torch.optim.optimizers import get_optimizer

    opt = get_optimizer("adamw", LR)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    step = steps.make_train_step(cfg, pcfg, mesh, opt, atk)
    total = WARM + n + (1 if profile else 0)
    batches = trainer.stack_window_batches(dcfg, 0, total, mesh, atk, cfg)
    params, opt_state = state["params"], state["opt_state"]
    ms, losses, prof = [], [], None
    for i in range(total):
        batch = {k: v[i] for k, v in batches.items()}
        if profile and i == total - 1:
            import chip_smoke as CS

            wall = statistics.median(ms)
            holder = {}

            def one():
                holder["out"] = step(params, opt_state, batch, i)
                torch.cuda.synchronize()

            prof = CS.profile_summary(one, wall, top=5)
            params, opt_state, met = holder["out"]
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, met = step(params, opt_state, batch, i)
            torch.cuda.synchronize()
            if i >= WARM:
                ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    del state, params, opt_state, batches, step
    torch.cuda.empty_cache()
    return ms, losses, prof


def part_norm(args) -> None:
    import torch

    from repro_torch.kernels import robust_agg

    robust_agg.prepare([("median", WORKERS, 0, torch.bfloat16)])
    for run in args.runs.split(","):
        cfg, mesh, pcfg, atk, dcfg = _setup(LAYERS["norm"], seq_parallel=run == "sp")
        torch.cuda.reset_peak_memory_stats()
        ms, losses, prof = _timed_steps(cfg, mesh, pcfg, atk, dcfg, args.steps, True)
        print(json.dumps({"part": "norm", "tree": args.tag, "run": run,
                          "step_ms": ms, "median_ms": statistics.median(ms),
                          "losses": losses, "launches_a_step": prof["launches"],
                          "device_busy_share": prof["device_busy_share"],
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)


def _sync_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def part_sketch(args) -> None:
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch import rng
    from repro_torch.models import transformer as T
    from repro_torch.rounds import compression as comp_lib

    dev = torch.device("cuda", 0)
    robust_agg.prepare([("median", WORKERS, 0, torch.bfloat16)])
    cfg, mesh, pcfg, atk, dcfg = _setup(LAYERS["sketch"], compression="count_sketch")
    d = T.count_params(cfg)
    gen = rng.generator(7, device=dev)
    h, s = comp_lib.sketch_draw(d, gen, 0.5, device=dev)
    x = torch.randn(d, generator=gen, device=dev) * s
    w = comp_lib._sketch_w(d, 0.5)
    out = {}
    for name, fn in (("index_add_", lambda z: z.index_add_(0, h, x)),
                     ("sketch_accumulate", lambda z: comp_lib.sketch_accumulate(z, h, x))):
        sums = []
        for _ in range(2):
            z = torch.zeros(w, device=dev)
            out.setdefault(name, []).append(_sync_ms(lambda: fn(z)))
            sums.append(z)
        out[name + "_bitwise_its_rerun"] = bool(torch.equal(sums[0], sums[1]))
        del sums, z
    small = 1 << 22
    hs, xs = h[:small] % (small // 2), x[:small]
    card = comp_lib.sketch_accumulate(torch.zeros(small // 2, device=dev), hs, xs).cpu()
    cpu = torch.zeros(small // 2).index_add_(0, hs.cpu(), xs.cpu())
    out["card_sorted_bitwise_cpu_index_add"] = bool(torch.equal(card, cpu))
    del h, s, x, hs, xs
    torch.cuda.empty_cache()
    print(json.dumps({"part": "sketch_accumulate", "d": d, "width": w, "ms": out}), flush=True)

    real = comp_lib.sketch_accumulate
    plain = lambda z, hh, v: z.index_add_(z.dim() - 1, hh, v)  # noqa: E731
    for name, fn in (("sketch_accumulate", real), ("index_add_", plain)) * 2:
        comp_lib.sketch_accumulate = fn
        try:
            torch.cuda.reset_peak_memory_stats()
            ms, losses, _ = _timed_steps(cfg, mesh, pcfg, atk, dcfg, args.steps, False)
        finally:
            comp_lib.sketch_accumulate = real
        print(json.dumps({"part": "sketch_step", "accumulate": name, "layers": cfg.n_layers,
                          "step_ms": ms, "median_ms": statistics.median(ms), "losses": losses,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("norm", "sketch"), required=True)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--runs", default="plain")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        CS.fail("no CUDA card")
    import repro_torch

    print(json.dumps({"tree": args.tag, "package": str(Path(repro_torch.__file__).parent)}))
    (part_norm if args.part == "norm" else part_sketch)(args)
    print(CS.card_line())
    print("done")


if __name__ == "__main__":
    main()
