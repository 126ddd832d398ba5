"""The readings a training cell's limits are set from, at the cell's own
size on the card, in one process:

- the program's numbers (``kinds.train.first_steps`` against the
  reference) on each of ``--seeds``;
- the control's: the reference put in the program's place and computed
  in float8 (the cell's reference module's ``fp8_matmul``) on each of
  ``--control-seeds``;
- each planted fault's (``faults.py``) on each of ``--fault-seeds``
  (``unchanged`` reads 1 by the measure and is not run).

    python3 chipbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --fault-seeds 1,2,3 --out <file.jsonl>

One JSON line a reading.  The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="half_batch,no_exchange,altered")
    ap.add_argument("--out", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the configuration's smoke sizes and 32-token rows (a CPU rehearsal)")
    args = ap.parse_args(argv)

    import torch

    from chipbench import bench, faults, generate
    from chipbench.kinds import train
    from chipbench.reference import train as reference

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = bench.load_cell(ROOT, args.workload)
    if args.smoke:
        cell.config["port"].update(cell.config["smoke"])
        cell.traffic.update(batch_per_worker=2, seq_len=32)
    t = cell.traffic
    model = cell.config["port"]
    n = t["check_steps"]
    out = open(args.out, "a")

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def program(seed, ring):
        prog = train.Program(cell, device)
        blocks = [{k: v[None] for k, v in b.items()} for b in ring]
        got = train.first_steps(prog.window(), prog.state(seed), blocks, n,
                                train.initial_weights(cell.reference, model, seed, device),
                                t["optimizer"]["b1"])
        got.pop("state")
        return got

    seeds = sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds))
    emit(kind="start", workload=cell.name, device=str(device),
         card=train.power_limit() if device.type == "cuda" else "cpu",
         setup_s=time.perf_counter() - T_START)
    for seed in seeds:
        ring = generate.make_ring(t, model["vocab"], seed, device)
        t0 = time.perf_counter()
        got = program(seed, ring) if seed in args.seeds else None
        free()
        t1 = time.perf_counter()
        ref = train.reference_readings(cell, seed, ring, n, device)
        t2 = time.perf_counter()
        if got is not None:
            med = sorted(ref["agg1"].values())[len(ref["agg1"]) // 2]
            worst = max(ref["agg1"], key=lambda p: abs(got["agg1"][p] - ref["agg1"][p])
                        / max(ref["agg1"][p], med))
            emit(kind="program", seed=seed, gaps=reference.gaps(got, ref), program_s=t1 - t0,
                 reference_s=t2 - t1, losses=got["losses"], ref_losses=ref["losses"],
                 grad1_worst_leaf=worst)
        free()
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            ctl = train.reference_readings(cell, seed, ring, n, device,
                                           cell.reference.fp8_matmul)
            emit(kind="control", seed=seed, gaps=reference.gaps(ctl, ref),
                 control_s=time.perf_counter() - t0)
            free()
        if seed in args.fault_seeds:
            for name in args.faults.split(","):
                with faults.planted(name):
                    bad = program(seed, ring)
                emit(kind="fault", fault=name, seed=seed, gaps=reference.gaps(bad, ref))
                free()
        del ring
        free()
    if device.type == "cuda":
        emit(kind="end", peak_gib=torch.cuda.max_memory_allocated(device) / (1 << 30),
             total_s=time.perf_counter() - T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
