#!/usr/bin/env python3
"""Per-step training losses of a model at ``chip_smoke.py`` phase 18b's
settings, on one CUDA card.

    python3 scripts/frontend_losses.py [--config internvl2-1b] [--steps 16]
                                       [--attacks alie,none] [--agg median]

For each attack it runs ``launch.trainer.train_loop`` with 4 in-process
workers at the configuration's full width and depth (bf16, seed 0),
global batch 8, seq 128, AdamW 1e-4, the gather strategy and ALIE's alpha
0.25 (0 without an attack), in windows of one step, and prints one line
per attack: the losses a step and the wall seconds, then the card's name
and power limit.  At m = 4 ALIE alpha 0.25 holds internvl2-1b's loss near
its start while the clean run's falls (PERF.md §6).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="internvl2-1b")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--attacks", default="alie,none")
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

    if not torch.cuda.is_available():
        CS.fail("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    trim = int(CS.TRAIN_BETA * CS.TRAIN_WORKERS) if args.agg == "trimmed_mean" else 0
    robust_agg.prepare([(args.agg, CS.TRAIN_WORKERS, trim, torch.bfloat16)])
    cfg = get_config(args.config)
    mesh = mesh_lib.make_debug_mesh(CS.TRAIN_WORKERS, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, **CS.TRAIN_DATA)
    pcfg = ParallelConfig(agg_method=args.agg, agg_strategy="gather", agg_beta=CS.TRAIN_BETA,
                          remat=False, attn_chunk=0)  # phase 18b's settings
    tcfg = TrainConfig(optimizer="adamw", lr=CS.TRAIN_LR, steps=args.steps, device_steps=1)
    for attack in args.attacks.split(","):
        atk = AttackConfig(attack, CS.TRAIN_ALPHA if attack != "none" else 0.0)
        t0 = time.perf_counter()
        r = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk)
        print(json.dumps({"config": cfg.name, "agg": args.agg, "attack": attack,
                          "losses": [h["loss"] for h in r.history],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        del r
        torch.cuda.empty_cache()
    print(CS.card_line())


if __name__ == "__main__":
    main()
