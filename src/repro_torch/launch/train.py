"""Training CLI: Byzantine-robust LM training on the port (the reference's
``python -m repro.launch.train``).

The front end of :mod:`repro_torch.launch.trainer`: windows of
``--device-steps`` micro-steps over the robust train step, engine attacks
applied at the aggregation.  ``--mesh debug --workers m`` (the
reference's default) runs m in-process workers on one device; ``--mesh
single`` runs one worker a process over a ``torch.distributed`` process
group, one card a rank (``--mesh multi``: a pod a host), launched by
``torchrun``; the mesh and window lines print on rank 0.  Runs on the
card by default; ``--device cpu`` runs on the CPU with the kernels' plain
versions (gloo under a process group)::

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --config llama3.2-3b --smoke --steps 4 --device-steps 2 --workers 4 \\
      --seq-len 32 --global-batch 4 --strategy bucketed --agg median \\
      --attack alie --attack-alpha 0.25
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh single \\
      --config llama3.2-3b --smoke --steps 4 --global-batch 4 --seq-len 32

Every configuration trains, whisper-small and internvl2-1b included: their
stub frontends (``launch.trainer.frontend_batch``: 1500 audio frames /
256 vision patches a row) ride each batch, and the startup line names
them (``frontend=audio:1500``).  ``--model-par N`` adds a model axis of N
(tensor parallelism): on the debug mesh each worker computes its N model
ranks in turn; under ``--mesh single|multi`` the world is workers × N
ranks, a worker's N ranks consecutive (``torchrun --nproc-per-node 4 ...
--mesh single --model-par 2``: 2 workers of 2 model ranks).  Every
configuration runs at N > 1: the dense and MoE families, mamba2 and
recurrentgemma (their mixers on each rank's heads or channels, the
out-projections row-parallel), whisper's encoder and
cross-attention and internvl2's vision prefix; so do ``--compression``
(each worker's whole gradient compressed) and a randomized ``--attack``
(``gauss``: each payload drawn over the whole leaf).  The train step runs with
``remat=True``, as the reference's CLI: each super-block and encoder
layer is recomputed in the backward instead of kept.
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint.checkpoint import save as save_ckpt
from repro_torch.configs import ParallelConfig, TrainConfig, get_config, get_smoke_config
from repro_torch.core.attacks import AttackConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import trainer
from repro_torch.launch.mesh import (make_debug_mesh, make_production_mesh, mesh_shape_dict,
                                     model_rank, model_size, num_workers)
from repro_torch.rounds import compression


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="Robust LM training via the device-steps window (launch.trainer)")
    ap.add_argument("--config", "--arch", dest="config", required=True,
                    help="architecture name from repro_torch.configs")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=16,
                    help="total optimizer steps (multiple of --device-steps)")
    ap.add_argument("--device-steps", type=int, default=1,
                    help="micro-steps per window (the host reads metrics between windows)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--mesh", default="debug", choices=["debug", "single", "multi"])
    ap.add_argument("--workers", type=int, default=4, help="debug mesh data axis")
    ap.add_argument("--model-par", type=int, default=1,
                    help="model axis: tensor parallelism over N ranks of each worker")
    ap.add_argument("--strategy", default="gather",
                    choices=["gather", "bucketed", "hierarchical", "chunked", "psum"])
    ap.add_argument("--agg", default="median",
                    choices=["mean", "median", "trimmed_mean",
                             "approx_median", "approx_trimmed_mean"])
    ap.add_argument("--beta", type=float, default=0.25)
    ap.add_argument("--compression", default="none",
                    choices=list(compression.registered_compressions()),
                    help="codec on each worker's transmitted gradient, before the "
                         "collective and any attack; topk carries error-feedback state")
    ap.add_argument("--attack", default="none")
    ap.add_argument("--attack-alpha", type=float, default=0.0)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-chunk", type=int, default=0, help="0 = plain attention")
    ap.add_argument("--log-every", type=int, default=1, help="in windows")
    ap.add_argument("--ckpt", default=None, help="save a final params checkpoint here on exit")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="snapshot the full window state every --ckpt-every windows")
    ap.add_argument("--ckpt-every", type=int, default=1, metavar="N",
                    help="snapshot period in windows (with --ckpt-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest snapshot in --ckpt-dir (bit for bit; a "
                         "fresh directory starts from scratch)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    cfg = get_smoke_config(args.config) if args.smoke else get_config(args.config)
    own_group = args.mesh != "debug" and not dist.is_initialized()
    if args.mesh == "debug":
        mesh = make_debug_mesh(args.workers, args.model_par, device=args.device)
    else:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"), model=args.model_par,
                                    device=args.device)
    try:
        _train(args, cfg, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()
    return 0


def _train(args, cfg, mesh) -> None:
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    m = num_workers(mesh)
    frontend = (f" frontend={cfg.frontend}:{cfg.n_frontend_tokens}"
                if cfg.frontend != "none" else "")
    say(f"mesh={mesh_shape_dict(mesh)} workers={m} device_steps={args.device_steps} "
        f"device {mesh.device.type}{frontend}")

    attack = AttackConfig(args.attack, args.attack_alpha)
    if args.strategy == "psum" and args.agg != "mean":
        say(f"note: --strategy psum forces --agg mean (was {args.agg})")
        args.agg = "mean"
    pcfg = ParallelConfig(agg_method=args.agg, agg_beta=args.beta,
                          agg_strategy=args.strategy, remat=True,
                          attn_chunk=args.attn_chunk, compression=args.compression)
    tcfg = TrainConfig(optimizer=args.optimizer, lr=args.lr, steps=args.steps,
                       seed=args.seed, attack=args.attack, attack_alpha=args.attack_alpha,
                       device_steps=args.device_steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch, num_workers=m, seed=args.seed)

    def on_window(w, met):
        say(f"step {met['step']:5d}  loss {met['loss']:.4f}  |g| {met['grad_norm']:.3f}")

    result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=attack,
                                log_every=args.log_every, on_window=on_window,
                                ckpt_every=args.ckpt_every if args.ckpt_dir else 0,
                                ckpt_dir=args.ckpt_dir, resume=bool(args.resume))
    say(f"done: {result.steps} steps in windows of {result.device_steps}  "
        f"first window {result.compile_s:.2f}s  "
        f"steady {result.steps_per_s:.2f} steps/s  "
        f"{result.tokens_per_s:.0f} tokens/s")
    # the params are replicated over the workers: worker 0 writes them, each
    # of its model ranks its own shards under a process group
    split = mesh.per_rank and model_size(mesh) > 1
    if args.ckpt and mesh.rank < model_size(mesh):
        path = f"{args.ckpt}.model{model_rank(mesh)}" if split else args.ckpt
        save_ckpt(path, {"params": result.state["params"]}, step=result.steps,
                  extra={"arch": cfg.name, "agg": args.agg, "strategy": args.strategy})
        say(f"saved checkpoint to {path}")


if __name__ == "__main__":
    raise SystemExit(main())
