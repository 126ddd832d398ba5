"""Serving shim: ``python -m repro_torch.launch.serve`` maps its
arguments onto ``python -m repro_torch.serve.run`` (the reference's
``repro.launch.serve``).  ``--batch`` maps to decode-pool slots and
``--gen`` to the per-request generation budget; traffic arrives at once
(latency "zero") so the pool fills immediately, and nothing adapts.
``--mesh``, ``--workers`` and ``--model-par`` are forwarded, with the
reference's defaults: the debug mesh of 4 workers and a model axis of 2
(tensor parallelism), at which every decoder serves, mamba2 and
recurrentgemma included.

Example::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --smoke \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.serve import run as serve_run


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="debug", choices=["debug", "single", "multi"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--model-par", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    fwd = [
        "--arch", args.arch,
        "--slots", str(args.batch),
        "--prompt-len", str(args.prompt_len),
        "--max-new", str(args.gen),
        "--requests", str(args.batch),
        "--latency", "zero",
        "--adapt-every", "0",
        "--mesh", args.mesh,
        "--workers", str(args.workers),
        "--model-par", str(args.model_par),
        "--device", args.device,
    ]
    if args.smoke:
        fwd.append("--smoke")
    return serve_run.main(fwd)


if __name__ == "__main__":
    raise SystemExit(main())
