"""One-round federated learning (paper Algorithm 2 / Table 4) on the
PyTorch/CUDA port (``examples/one_round_federated.py`` on ``repro_torch``).

Each of m=10 "devices" trains a local multi-class logistic regression on
its own data (some devices hold random labels — the paper's one-round
Byzantine model); the server aggregates the m local models with a single
coordinate-wise median. One communication round total. On the card the
median is the hand-written order-statistic kernel.

Also runs the federated-scale path of the same algorithm
(``repro_torch.rounds.one_round_streaming``): the m local solutions are
folded into the streaming histogram sketch chunk by chunk (the min/max and
histogram kernels on the card), so the (m, d) solution matrix never
exists — the path that takes one-round to m = 10⁵ clients.

Run:  PYTHONPATH=src python examples/torch_one_round_federated.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.attacks import AttackConfig
from repro_torch.core.robust_gd import make_worker_shards
from repro_torch.data.synthetic import mnist_analog
from repro_torch.models.paper_models import init_logreg, logreg_accuracy, logreg_loss
from repro_torch.rounds import (
    OneRoundConfig,
    make_gd_local_solver,
    one_round,
    one_round_streaming,
)

SEED, TEST_SEED, LABEL_SEED = 0, 99, 1
M, N, D, C = 10, 500, 784, 10
TEST_N = 2000
ATTACK = AttackConfig("random_label", alpha=0.1, num_classes=C)
LOCAL_STEPS, LOCAL_LR = 150, 0.3
CHUNK_WORKERS, NBINS = 4, 512


def make_data(device="cuda"):
    """(worker shards {"x": (M, N, D), "y": (M, N)} with the Byzantine
    workers' labels drawn iid uniform, the test set)."""
    train = mnist_analog(torch.Generator().manual_seed(SEED), M * N, d=D, num_classes=C,
                         device=device)
    test = mnist_analog(torch.Generator().manual_seed(TEST_SEED), TEST_N, d=D,
                        num_classes=C, device=device)
    xs, ys = make_worker_shards((train["x"], train["y"]), M)
    # the paper's one-round attack: Byzantine workers train on iid-uniform
    # random labels, drawn from their own generator
    q = ATTACK.num_byzantine(M)
    ys = ys.clone()
    ys[:q] = torch.randint(0, C, tuple(ys[:q].shape),
                           generator=torch.Generator().manual_seed(LABEL_SEED)).to(ys)
    return {"x": xs, "y": ys}, test


def make_solver(device="cuda"):
    w0 = init_logreg(d=D, num_classes=C, device=device)
    return make_gd_local_solver(lambda w, b: logreg_loss(w, {"x": b["x"], "y": b["y"]}), w0,
                                steps=LOCAL_STEPS, lr=LOCAL_LR)


def run(shards, test, solver) -> dict:
    """Mean and median through ``one_round``, then the median through the
    streaming sketch -> ``{"acc": {name: test accuracy}, "w": {name:
    aggregated params}}``."""
    acc, ws = {}, {}
    for method in ("mean", "median"):
        ws[method] = one_round(solver, shards, OneRoundConfig(method))
        acc[method] = float(logreg_accuracy(ws[method], test))
        print(f"  {method:7s} aggregation: test accuracy {acc[method] * 100:5.1f}%")

    # federated-scale path: the same estimator through the streaming
    # histogram sketch (within one bin width), no (m, d) matrix
    ws["median_stream"] = one_round_streaming(solver, shards, OneRoundConfig("median"),
                                              chunk_workers=CHUNK_WORKERS, nbins=NBINS)
    acc["median_stream"] = float(logreg_accuracy(ws["median_stream"], test))
    print(f"  median (streaming sketch): test accuracy {acc['median_stream'] * 100:5.1f}%")
    return {"acc": acc, "w": ws}


def main(argv=None) -> dict:
    """The example on ``--device``; returns :func:`run`'s figures with the
    shards and the solver (``"shards"``, ``"solver"``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    shards, test = make_data(args.device)
    solver = make_solver(args.device)
    print(f"m={M} workers, {ATTACK.num_byzantine(M)} Byzantine (random labels), "
          f"one communication round")
    return dict(run(shards, test, solver), shards=shards, solver=solver)


if __name__ == "__main__":
    main()
