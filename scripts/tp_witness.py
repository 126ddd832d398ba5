#!/usr/bin/env python3
"""Training at model size 1 and 2 side by side, on one CUDA card: the
readings that set ``chip_smoke.py`` phase 20b's and 20c's limits.

    python3 scripts/tp_witness.py [--config llama3.2-3b] [--layers 8]
                                  [--dtype bfloat16] [--steps 8]
                                  [--device-steps 1] [--runs 1,1,2,2f]
                                  [--agg median]

Each entry of ``--runs`` is one ``launch.trainer.train_loop`` from the
same seeded params over ``make_debug_mesh(4, model)`` at phase 20b's
settings (gather ``--agg``, median or trimmed mean beta 0.25, under ALIE
alpha 0.25, AdamW 1e-4, batch 8, seq 128), in windows of
``--device-steps`` steps (one by default, so that every step is read;
the phase's window reads as the phase does): ``1`` at model 1, ``2`` at
model 2, ``2f`` at model 2 with every leaf the model axis splits frozen
(its AdamW update dropped) -- what a tensor-parallel update that never
reaches the split leaves reads.  TF32 is off.

For each run it prints one JSON line: the losses and the aggregate's
gradient norms a window (each the mean of its steps'), each window's
relative distance from the first run's (loss and norm), and the update against the first run's:
``|u - u_ref| / |u_ref|`` with ``u`` = final params - initial params, over
all leaves, the split ones and the replicated ones, and the share of
coordinates whose final value is bitwise the first run's.  Then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="llama3.2-3b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device-steps", type=int, default=1)
    ap.add_argument("--runs", default="1,1,2,2f")
    ap.add_argument("--agg", default="median")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import robust_agg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer
    from repro_torch.models import sharding
    from repro_torch.optim.optimizers import Optimizer, get_optimizer
    from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten_like

    if not torch.cuda.is_available():
        CS.fail("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    trim = int(CS.TRAIN_BETA * CS.TRAIN_WORKERS) if args.agg == "trimmed_mean" else 0
    robust_agg.prepare([(args.agg, CS.TRAIN_WORKERS, trim, dtype)])
    cfg = dataclasses.replace(get_config(args.config), n_layers=args.layers, dtype=args.dtype)
    dcfg = DataConfig(vocab=cfg.vocab, **CS.TRAIN_DATA)
    pcfg = ParallelConfig(agg_method=args.agg, agg_strategy="gather", agg_beta=CS.TRAIN_BETA,
                          remat=False, attn_chunk=0)  # phase 20b's settings
    tcfg = TrainConfig(optimizer="adamw", lr=CS.TRAIN_LR, steps=args.steps,
                       device_steps=args.device_steps)
    atk = AttackConfig("alie", CS.TRAIN_ALPHA)
    plan = sharding.tp_plan(cfg, CS.TP_MODEL)
    paths = [p for p, _ in tree_leaves_with_path(trainer.T.meta_params(cfg))]
    split = [p in plan for p in paths]

    def frozen(inner: Optimizer) -> Optimizer:
        def update(grads, state, params, step):
            new, st = inner.update(grads, state, params, step)
            keep = [p if s else n for n, p, s in zip(tree_leaves(new), tree_leaves(params), split)]
            return tree_unflatten_like(new, keep), st
        return Optimizer(inner.init, update)

    mesh1 = mesh_lib.make_debug_mesh(CS.TRAIN_WORKERS, 1, device=dev)
    init = [t.cpu() for t in tree_leaves(trainer.init_state(
        cfg, mesh1, get_optimizer("sgd", 0.0), seed=tcfg.seed)["params"])]
    torch.cuda.empty_cache()
    ref = None
    for run in args.runs.split(","):
        model = int(run.rstrip("f"))
        mesh = mesh_lib.make_debug_mesh(CS.TRAIN_WORKERS, model, device=dev)
        base = trainer.get_optimizer
        if run.endswith("f"):
            trainer.get_optimizer = lambda *a, **k: frozen(base(*a, **k))
        t0 = time.perf_counter()
        try:
            r = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk)
        finally:
            trainer.get_optimizer = base
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [h["loss"] for h in r.history]
        norms = [h["grad_norm"] for h in r.history]
        final = [t.cpu() for t in tree_leaves(r.state["params"])]
        del r
        torch.cuda.empty_cache()
        line = {"run": run, "config": cfg.name, "layers": cfg.n_layers, "dtype": args.dtype,
                "agg": args.agg, "model": model, "frozen_split_leaves": run.endswith("f"),
                "losses": losses, "grad_norms": norms, "wall_s": wall,
                "split_leaves": sum(split), "leaves": len(split)}
        if ref is None:
            ref = {"run": run, "losses": losses, "grad_norms": norms, "final": final}
        else:
            same = sum(int((a == b).sum()) for a, b in zip(final, ref["final"]))
            groups = {"all": [True] * len(split), "split": split,
                      "replicated": [not v for v in split]}
            line.update(
                against=ref["run"],
                loss_rel=[abs(x - y) / abs(y) for x, y in zip(losses, ref["losses"])],
                norm_rel=[abs(x - y) / abs(y) for x, y in zip(norms, ref["grad_norms"])],
                update_rel={k: CS.tp_update_rel(*([x for x, w in zip(leaves, g) if w]
                                                   for leaves in (init, final, ref["final"])),
                                                 dev) for k, g in groups.items()},
                bitwise_share=same / sum(t.numel() for t in final))
        print(json.dumps(line), flush=True)
        del final
    print(CS.card_line())


if __name__ == "__main__":
    main()
