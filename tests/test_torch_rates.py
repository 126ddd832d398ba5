"""Theorem 1's rates on the port's Algorithm 1 (the CPU half of the
reference's rate checks, tests/test_robust_gd.py::TestRobustGD's
``test_error_increases_with_alpha`` and ``test_error_decreases_with_n``):
``repro_torch.core.robust_gd.run_linreg_experiment`` with the reference's
settings (d = 20, sigma 0.5, step 0.5, the median over m workers,
Rademacher features) and the same assertions, on the CPU.

The draws are the port's (a torch generator from seed 0), not the
reference's threefry, so the errors are the port's own; the assertions
are the reference's, no looser.

Serial time: ~3 s on 2 threads (2 tests).
"""
import torch

from repro_torch.core.attacks import AttackConfig
from repro_torch.core.robust_gd import RobustGDConfig, run_linreg_experiment

torch.set_num_threads(2)


def _run(method, attack, n=200, m=20, beta=0.2, iters=60):
    cfg = RobustGDConfig(method=method, beta=beta, step_size=0.5, num_iters=iters)
    err, traj = run_linreg_experiment(0, d=20, n=n, m=m, sigma=0.5, cfg=cfg, attack=attack,
                                      device="cpu")
    return float(err), traj


def test_error_increases_with_alpha():
    """Theorem 1: statistical error grows with the Byzantine fraction."""
    errs = []
    for alpha in (0.0, 0.1, 0.2, 0.3):
        attack = AttackConfig("mean_shift", alpha=alpha, shift=3.0)
        err, _ = _run("median", attack, n=500, m=20, iters=80)
        errs.append(err)
    assert errs[-1] > errs[0], errs
    # monotone-ish: allow small noise inversions between adjacent alphas
    assert errs[3] >= errs[1] * 0.8, errs


def test_error_decreases_with_n():
    """Theorem 1: error ~ 1/sqrt(n) in the clean case."""
    e_small, _ = _run("median", None, n=50, m=10, iters=80)
    e_big, _ = _run("median", None, n=1600, m=10, iters=80)
    assert e_big < e_small, (e_small, e_big)
