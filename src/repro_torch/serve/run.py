"""CLI for robust serving: ``python -m repro_torch.serve.run``.

Serves a seeded simulated traffic stream through the continuous-batching
engine while the traffic's feedback feeds Byzantine-robust continual
fine-tuning rounds on a tick cadence, hot-swapping each fresh iterate into
the running pool.  Runs on the card by default (``--device cuda``);
``--device cpu`` runs on the CPU with the kernels' plain versions::

    PYTHONPATH=src python -m repro_torch.serve.run --device cpu --smoke \\
        --arch llama3_2_3b --requests 24 --slots 3 --shards 2 --alpha 0.5 \\
        --adapt-every 8 --method median

``--arch`` takes every decoder of ``repro_torch.configs``: the dense
models, granite_moe_1b_a400m and grok_1_314b (MoE; grok at ``--smoke``
only, its 316·10^9 parameters fit no card), mamba2_2_7b (SSM) and
recurrentgemma_2b (hybrid RG-LRU); whisper and internvl2 are not served
(the reference's engine prefills without a frontend).  ``--adapt-every
0`` disables adaptation (the serve-only baseline).  The
last line prints ``final iterate sha256 = ...`` as ``fed/run.py`` does; two
identical invocations print the same digest.

``--mesh/--workers/--model-par`` are the reference's: ``debug`` runs on
``make_debug_mesh(workers, model_par)`` in this process, ``single`` /
``multi`` on this rank's card of a ``torch.distributed`` process group
(``make_production_mesh``): every rank serves the same stream and rank 0
prints.  The worker axes spread no serving work (the slot pool is
replicated over them, as the reference's).  ``--model-par`` > 1 is tensor
parallelism, for every decoder: the engine, its pool and the adaptation
rounds run on the model shards (on ``debug`` each layer's model ranks in
turn on the global view; under a process group a rank holds its shards
and its kv heads, mamba2's SSD its heads and recurrentgemma's RG-LRU its
channels, with their states), with
``--compression`` and a randomized gradient attack on the global rows.  The
header names the mesh (``mesh={'data': 4, 'model': 2}``) and the sha256
is taken over the global iterate, so a run prints the same digest at
every model size and on either mesh.  The reference's CI smoke command
runs as it is, with ``--device cpu`` on the CPU::

    PYTHONPATH=src python -m repro_torch.serve.run --device cpu --smoke \\
        --arch llama3_2_3b --workers 2 --model-par 1 --requests 24 \\
        --alpha 0.25 --attack feedback_flip
"""
from __future__ import annotations

import argparse
import hashlib


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.run",
        description="Continuous-batching serving with Byzantine-robust "
                    "continual fine-tuning from simulated user feedback")
    p.add_argument("--arch", default="llama3_2_3b")
    p.add_argument("--smoke", action="store_true",
                   help="smoke-scale model config (CPU-friendly)")
    # engine
    p.add_argument("--slots", type=int, default=4,
                   help="decode pool lanes (continuous batching width)")
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--eos-id", type=int, default=-1,
                   help="retire a slot on this token (-1 = length only)")
    p.add_argument("--window", type=int, default=64,
                   help="metrics window in ticks")
    # traffic
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--num-users", type=int, default=1_000_000)
    p.add_argument("--shards", type=int, default=4,
                   help="gradient shards the user population maps onto")
    p.add_argument("--alpha", type=float, default=0.0,
                   help="Byzantine fraction (contiguous user blocks -> "
                        "fully-Byzantine shards)")
    p.add_argument("--attack", default="feedback_flip",
                   help="registered feedback-access attack")
    p.add_argument("--strength", type=float, default=None)
    p.add_argument("--latency", default="exponential",
                   choices=["zero", "uniform", "exponential", "lognormal"])
    p.add_argument("--latency-scale", type=float, default=2.0)
    p.add_argument("--latency-spread", type=float, default=1.0)
    # adaptation
    p.add_argument("--adapt-every", type=int, default=32,
                   help="robust-round cadence in ticks (0 = serve only)")
    p.add_argument("--batch-per-shard", type=int, default=2)
    p.add_argument("--method", default="median",
                   help="robust aggregator (core.aggregators)")
    p.add_argument("--beta", type=float, default=0.2)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--compression", default="none",
                   help="wire codec on the gradient rows (rounds.compression)")
    p.add_argument("--ckpt-dir", default=None, metavar="DIR",
                   help="snapshot the adaptation RoundState after every "
                        "round (rounds.engine atomic LATEST)")
    # mesh
    p.add_argument("--mesh", default="debug", choices=["debug", "single", "multi"],
                   help="debug: one process; single|multi: join a torch.distributed "
                        "process group, every rank serving the whole stream (rank 0 "
                        "prints)")
    p.add_argument("--workers", type=int, default=1,
                   help="debug mesh data axis (the slot pool is replicated over it)")
    p.add_argument("--model-par", type=int, default=1,
                   help="model axis: tensor parallelism of the engine and the rounds")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def iterate_digest(w) -> str:
    """sha256 of the served iterate's raveled bytes (bfloat16 leaves as
    their 16-bit patterns), bit for bit; ``w`` the global iterate (a
    process group's ranks gather theirs first), so every rank and every
    model size prints one digest for one iterate."""
    import torch

    from repro_torch.tree import ravel

    flat = ravel(w)[0].detach().cpu().contiguous()
    if flat.dtype == torch.bfloat16:
        flat = flat.view(torch.int16)
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    own_group = args.mesh != "debug" and not dist.is_initialized()
    if args.mesh == "debug":
        mesh = make_debug_mesh(args.workers, args.model_par, device=args.device)
    else:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"), model=args.model_par,
                                    device=args.device)
    try:
        _serve(args, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()
    return 0


def _serve(args, mesh) -> None:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.fed.population import ArrivalConfig
    from repro_torch.launch.mesh import mesh_shape_dict
    from repro_torch.models import transformer as T
    from repro_torch.serve.adapt import AdaptConfig, FeedbackAdapter
    from repro_torch.serve.engine import (ServeConfig, ServeEngine, latency_stats,
                                          refuse_frontend, serve_stream)
    from repro_torch.serve.traffic import TrafficConfig, VirtualUsers

    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    dev = mesh.device
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    refuse_frontend(cfg)
    scfg = ServeConfig(slots=args.slots, prompt_len=args.prompt_len,
                       max_new=args.max_new, eos_id=args.eos_id, window=args.window)
    tcfg = TrafficConfig(
        num_users=args.num_users, num_shards=args.shards, alpha=args.alpha,
        attack=args.attack, strength=args.strength,
        prompt_len=args.prompt_len, min_gen=max(1, args.max_new // 4),
        max_gen=args.max_new, vocab=cfg.vocab,
        arrival=ArrivalConfig(latency=args.latency, scale=args.latency_scale,
                              spread=args.latency_spread),
        seed=args.seed)
    users = VirtualUsers(tcfg)

    say(f"model: {cfg.name} (vocab {cfg.vocab}); mesh {args.mesh} workers={args.workers} "
        f"model_par={args.model_par}; device {dev}; mesh={mesh_shape_dict(mesh)}")
    say(f"engine: {scfg.slots} slots, prompt bucket {scfg.prompt_len}, "
        f"max_new {scfg.max_new} (cache {scfg.cache_len})")
    say(f"traffic: {args.requests} requests from {tcfg.num_users} users "
        f"over {tcfg.num_shards} shards "
        f"({tcfg.num_byz_shards} Byzantine via {tcfg.attack!r} at "
        f"alpha={tcfg.alpha}), latency={args.latency}")

    params = T.init_params(cfg, seed=args.seed, device=dev)
    engine = ServeEngine(cfg, scfg, params, mesh)
    adapter = None
    if args.adapt_every > 0:
        acfg = AdaptConfig(
            method=args.method, beta=args.beta, optimizer=args.optimizer, lr=args.lr,
            compression=args.compression, batch_per_shard=args.batch_per_shard,
            adapt_every=args.adapt_every, seed=args.seed)
        adapter = FeedbackAdapter(cfg, acfg, users, params, ckpt_dir=args.ckpt_dir, mesh=mesh)
        say(f"adaptation: every {acfg.adapt_every} ticks, "
            f"B={acfg.batch_per_shard}/shard, method={acfg.method}, "
            f"opt={acfg.optimizer}@{acfg.lr}, compression={acfg.compression}"
            + (f", ckpt={args.ckpt_dir}" if args.ckpt_dir else ""))
    del params

    requests = users.sample_requests(args.requests)
    completed = serve_stream(engine, requests, adapter=adapter)

    for w in engine.metrics.windows:
        say(f"  window {w['window']:3d}  {w['tokens']:5d} tok "
            f"{w['tok_per_s']:9.1f} tok/s  occ={w['occupancy']:.2f}  "
            f"p50={w['p50_latency']:.1f} p99={w['p99_latency']:.1f} ticks "
            f"({w['completed']} done)")
    stats = latency_stats(completed)
    mt = engine.metrics
    say(f"served {len(completed)}/{args.requests} requests, "
        f"{mt.total_tokens} tokens in {mt.total_wall:.2f}s "
        f"({mt.total_tokens / mt.total_wall:.1f} tok/s), {engine.tick} ticks")
    say(f"latency p50={stats['p50_latency']:.1f} p99={stats['p99_latency']:.1f} ticks "
        f"(queue wait p50={stats['p50_wait']:.1f} p99={stats['p99_wait']:.1f})")
    say(f"storage kept: {engine.storage_kept()}")
    if adapter is not None:
        for h in adapter.history:
            say(f"  round {h['round']:3d}  |g|={h['grad_norm']:9.4f}  "
                f"score={h['score_mean']:+.3f} (honest {h['score_honest_mean']:+.3f})")
        say(f"adaptation rounds: {adapter.rounds_done} (params v{engine.params_version})")
        w = adapter.global_iterate()
    else:
        w = engine.shards.gather(engine.params)
    say(f"final iterate sha256 = {iterate_digest(w)}")


if __name__ == "__main__":
    raise SystemExit(main())
