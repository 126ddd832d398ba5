"""CLI for the federated-scale simulation: ``python -m repro_torch.fed.run``.

Runs synchronous rounds on the card by default (``--device cuda``);
``--device cpu`` runs them on the CPU with the kernels' plain versions.

Examples
--------
Clean 10⁴-client population, 2048-client cohorts, histogram median::

    python -m repro_torch.fed.run --clients 10000 --cohort 2048 --rounds 10

10%% Byzantine sign-flip vs the non-robust mean baseline::

    python -m repro_torch.fed.run --alpha 0.1 --attack sign_flip --method stream_mean
    python -m repro_torch.fed.run --alpha 0.1 --attack sign_flip --method approx_median

Attack mixture cycling sign_flip and alie each round::

    python -m repro_torch.fed.run --alpha 0.1 --attack sign_flip,alie
"""
from __future__ import annotations

import argparse
import hashlib

from repro_torch.core import theory
from repro_torch.core.attacks import AttackConfig
from repro_torch.fed.population import ClientPopulation, PopulationConfig
from repro_torch.fed.rounds import AttackMixture, RoundConfig, run_rounds


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.fed.run",
        description="Federated-scale Byzantine-robust simulation "
                    "(streaming histogram aggregation)")
    p.add_argument("--clients", type=int, default=10_000)
    p.add_argument("--cohort", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--samples-per-client", type=int, default=32)
    p.add_argument("--method", default="approx_median",
                   help="approx_median|approx_trimmed_mean|stream_mean or any "
                        "exact aggregator (median, trimmed_mean, mean, ...)")
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--nbins", type=int, default=256)
    p.add_argument("--alpha", type=float, default=0.0,
                   help="Byzantine fraction of the population")
    p.add_argument("--attack", default="sign_flip",
                   help="comma-separated per-round attack candidates — any "
                        "registered name (python -c 'from repro_torch import "
                        "attacks; print(attacks.registered())')")
    p.add_argument("--schedule", default="cycle",
                   choices=["cycle", "fixed", "greedy"],
                   help="per-round attack schedule; greedy = adaptive "
                        "adversary (explore, then replay the most damaging)")
    p.add_argument("--attack-scale", type=float, default=100.0)
    p.add_argument("--attack-shift", type=float, default=1.0)
    p.add_argument("--heterogeneity", type=float, default=0.0)
    p.add_argument("--noise", type=float, default=1.0)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--local-steps", type=int, default=1,
                   help="tau: local SGD steps per round (1 = FedSGD)")
    p.add_argument("--local-lr", type=float, default=0.1,
                   help="local SGD lr used when --local-steps > 1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.add_argument("--ckpt-dir", default=None, metavar="DIR",
                   help="write a RoundState snapshot (iterate, optimizer "
                        "state, prev aggregate, scheduler table) every "
                        "--ckpt-every rounds")
    p.add_argument("--ckpt-every", type=int, default=1, metavar="N",
                   help="snapshot period in rounds (with --ckpt-dir)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest snapshot in --ckpt-dir "
                        "(bit-for-bit identical to the uninterrupted run; "
                        "a fresh directory starts from scratch)")
    return p


def iterate_digest(w) -> str:
    """sha256 of the final iterate's float32 bytes (bit-for-bit, not a
    tolerance)."""
    return hashlib.sha256(w.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    pcfg = PopulationConfig(
        num_clients=args.clients, samples_per_client=args.samples_per_client,
        dim=args.dim, alpha=args.alpha, heterogeneity=args.heterogeneity,
        noise=args.noise, seed=args.seed)
    pop = ClientPopulation(pcfg, device=args.device)
    rcfg = RoundConfig(
        num_rounds=args.rounds, cohort_size=args.cohort,
        chunk_clients=args.chunk, method=args.method, beta=args.beta,
        nbins=args.nbins, optimizer=args.optimizer,
        lr=args.lr, seed=args.seed, local_steps=args.local_steps,
        local_lr=args.local_lr)
    attacks = ()
    if args.alpha > 0:
        attacks = tuple(
            AttackConfig(name=a.strip(), alpha=args.alpha,
                         scale=args.attack_scale, shift=args.attack_shift)
            for a in args.attack.split(",") if a.strip())
    print(f"population: {pcfg.num_clients} clients "
          f"({pcfg.num_byzantine()} Byzantine), d={pcfg.dim}, "
          f"n={pcfg.samples_per_client}/client, "
          f"heterogeneity={pcfg.heterogeneity}")
    print(f"rounds: {rcfg.num_rounds} x cohort {rcfg.cohort_size} "
          f"(chunks of {rcfg.chunk_clients}), method={rcfg.method}, "
          f"nbins={rcfg.nbins}, tau={rcfg.local_steps}, device={pop.device}")
    mixture = AttackMixture(attacks, schedule=args.schedule)
    if args.ckpt_dir:
        print(f"checkpoint: dir={args.ckpt_dir} every={args.ckpt_every} "
              f"resume={args.resume}")
    w, history = run_rounds(
        pop, rcfg, mixture, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every if args.ckpt_dir else 0, resume=bool(args.resume))
    for h in history:
        print(f"  round {h['round']:3d}  attack={h['attack']:<12s} "
              f"|g|={h['grad_norm']:9.4f}  |w-w*|={h['err']:.4f}")
    final = history[-1]["err"]
    rate = theory.optimal_rate(args.alpha, args.samples_per_client, args.cohort)
    print(f"final |w-w*| = {final:.4f}   "
          f"(order-optimal rate alpha/sqrt(n)+1/sqrt(n*m) = {rate:.4f})")
    print(f"final iterate sha256 = {iterate_digest(w)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
