"""Quickstart on the PyTorch/CUDA port: Byzantine-robust distributed
training in 60 lines (``examples/quickstart.py`` on ``repro_torch``).

Simulates the paper's setting: m=8 worker machines (2 Byzantine, sending
sign-flipped gradients), linear regression with Rademacher features
(Proposition 1), comparing mean / median / trimmed-mean aggregation. On
the card the median and trimmed mean run the hand-written order-statistic
kernels.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core.attacks import AttackConfig
from repro_torch.core.robust_gd import RobustGDConfig, run_linreg_experiment
from repro_torch.core.theory import c_eps, median_rate

SEED = 0
N, M, D, SIGMA = 500, 8, 20, 0.5
ATTACK = AttackConfig("sign_flip", alpha=0.25, scale=10.0)
ROBUST = 0.2  # ||w - w*|| below this is ROBUST


def main(argv=None) -> dict:
    """Run the three aggregators; returns ``{"err": {method: ||w - w*||},
    "rate": the paper's rate}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rate = c_eps(1 / 6) * median_rate(ATTACK.alpha, N, M)
    print(f"m={M} workers, n={N} samples each, d={D}, "
          f"{ATTACK.num_byzantine(M)} Byzantine ({ATTACK.name})")
    print(f"paper rate  ~ C_eps * (a/sqrt(n) + 1/sqrt(nm) + 1/n) = {rate:.4f}\n")
    errs = {}
    for method in ("mean", "median", "trimmed_mean"):
        cfg = RobustGDConfig(method=method, beta=0.3, step_size=0.5, num_iters=100)
        err, _ = run_linreg_experiment(SEED, d=D, n=N, m=M, sigma=SIGMA, cfg=cfg,
                                       attack=ATTACK, device=args.device)
        errs[method] = float(err)
        status = "ROBUST" if errs[method] < ROBUST else "BROKEN"
        print(f"{method:13s} ||w - w*|| = {errs[method]:8.4f}   [{status}]")
    return {"err": errs, "rate": rate}


if __name__ == "__main__":
    main()
