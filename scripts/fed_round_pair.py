#!/usr/bin/env python3
"""Time the port's federated round in two checkouts, in turns, on one CUDA card.

    python3 scripts/fed_round_pair.py PARENT_DIR [CHANGE_DIR] [--rounds N] [--pairs P]

Each checkout is a directory holding ``src/repro_torch`` and ``chip_smoke.py``
(``git archive`` of a commit, unpacked; CHANGE_DIR defaults to this
repository).  For each of P pairs it runs parent, change, change, parent
(reversed on odd pairs), each in a fresh process that builds its own
kernels, runs one warm-up round and then times ``fed.rounds.run_rounds``
for N rounds of approx_median at ``chip_smoke.py``'s fed_scale
configuration (10^5-client cohorts in 512-row chunks), host clock around
the rounds ending in a synchronize.  One JSON line per run: rounds/s, the
final ||w - w*|| (which must agree between the checkouts, since the sketch
kernels of both are bitwise equal to the same plain versions) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
import chip_smoke as C
from repro_torch.fed.population import ClientPopulation, PopulationConfig
from repro_torch.fed.rounds import RoundConfig, run_rounds

rounds = int(sys.argv[2])
pop = ClientPopulation(PopulationConfig(**C.FED_POP), device="cuda")
run_rounds(pop, RoundConfig(num_rounds=1, method="approx_median", **C.FED_ROUNDS), C.fed_attack())
cfg = RoundConfig(num_rounds=rounds, method="approx_median", **C.FED_ROUNDS)
torch.cuda.synchronize()
t0 = time.perf_counter()
_, hist = run_rounds(pop, cfg, C.fed_attack())
torch.cuda.synchronize()
dt = time.perf_counter() - t0
print(json.dumps({"rounds_per_s": rounds / dt, "ms_per_round": dt / rounds * 1e3,
                  "err_final": hist[-1]["err"]}))
"""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=str(ROOT))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    card = card_line()
    sides = {"parent": Path(args.parent).resolve(), "change": Path(args.change).resolve()}
    errs = {}
    for pair in range(args.pairs):
        order = ["parent", "change", "change", "parent"]
        if pair % 2:
            order.reverse()
        for side in order:
            out = subprocess.run(
                [sys.executable, "-c", CHILD, str(sides[side]), str(args.rounds)],
                capture_output=True,
                text=True,
                env=dict(os.environ),
                timeout=900,
            )
            if out.returncode != 0:
                raise SystemExit(f"{side} run failed:\n{out.stderr[-3000:]}")
            row = json.loads(out.stdout.strip().splitlines()[-1])
            errs.setdefault(side, set()).add(row["err_final"])
            print(json.dumps({"pair": pair, "side": side, **row, "card": card}), flush=True)
    if len(errs["parent"] | errs["change"]) != 1:
        raise SystemExit(f"the checkouts' trajectories differ: {errs}")


if __name__ == "__main__":
    main()
