"""End to end on the PyTorch/CUDA port: train a ~100M-param LM
under Byzantine attack with median aggregation, on an in-process mesh of 4
workers × 2-way model parallel (``examples/train_lm_robust.py`` on
``repro_torch``).

This is the "real system" example: the production train step (the
workers' gradients on each worker's shard, the bucketed robust
aggregation, whose median is the hand-written order-statistic kernel on
the card), the worker-sharded data with per-worker Byzantine label
corruption, AdamW and a checkpoint at the end.  The 4 × 2 mesh lives in
this process on one device (``launch.mesh.make_debug_mesh``); the batch
is made on that device.

Run:  PYTHONPATH=src python examples/torch_train_lm_robust.py [--steps 300] [--device cpu]
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import save as save_ckpt
from repro_torch.configs import ParallelConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attacks import AttackConfig
from repro_torch.data.pipeline import DataConfig, make_lm_batch
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer

# ~100M params: 8L, d=768, llama-style
CFG = ModelConfig(
    name="demo-100m", family="dense", n_layers=8, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=2048, vocab=32000, rope_theta=10000.0,
)
WORKERS, MODEL_PAR = 4, 2
LR = 3e-4
PRINT_EVERY = 20


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--agg", default="median")
    ap.add_argument("--attack", default="label_flip")
    ap.add_argument("--attack-alpha", type=float, default=0.25)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_demo_ckpt"))
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    """``--steps`` AdamW steps of ``CFG`` on the (4, 2) mesh of ``--device``
    from seed 0's params, then a checkpoint of the params at ``--ckpt``.
    Returns the per-step ``losses`` and ``grad_norms`` (floats),
    ``s_per_step`` over the run, the final ``params`` and the ``mesh``."""
    args = build_parser().parse_args(argv)
    cfg = CFG
    print(f"model: {T.count_params(cfg) / 1e6:.1f}M params; mesh {WORKERS} workers x "
          f"{MODEL_PAR} TP; attack={args.attack} alpha={args.attack_alpha} agg={args.agg}")
    mesh = make_debug_mesh(WORKERS, MODEL_PAR, device=args.device)
    attack = AttackConfig(args.attack, args.attack_alpha)
    pcfg = ParallelConfig(agg_method=args.agg, agg_strategy="bucketed",
                          remat=False, attn_chunk=0)
    opt = get_optimizer("adamw", LR)
    dcfg = DataConfig(kind="lm", vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, num_workers=WORKERS)

    params = T.init_params(cfg, seed=0, device=mesh.device)
    opt_state = opt.init(params)
    train_step = steps.make_train_step(cfg, pcfg, mesh, opt, attack)

    metrics = []  # 0-dim tensors on the device: read at the print steps only
    t0 = time.time()
    for step in range(args.steps):
        batch = make_lm_batch(dcfg, step, attack, device=mesh.device)
        params, opt_state, met = train_step(params, opt_state, batch, step)
        metrics.append((met["loss"], met["grad_norm"]))
        if step % PRINT_EVERY == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(met['loss']):.4f}  "
                  f"|g| {float(met['grad_norm']):.3f}  "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")
    s_per_step = (time.time() - t0) / max(args.steps, 1)
    save_ckpt(args.ckpt, {"params": params}, step=args.steps,
              extra={"arch": cfg.name, "agg": args.agg})
    print(f"done; checkpoint at {args.ckpt}")
    losses = torch.stack([lo for lo, _ in metrics]).tolist() if metrics else []
    norms = torch.stack([g for _, g in metrics]).tolist() if metrics else []
    return {"losses": losses, "grad_norms": norms, "s_per_step": s_per_step,
            "params": params, "mesh": mesh}


if __name__ == "__main__":
    main()
