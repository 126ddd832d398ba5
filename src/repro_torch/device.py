"""The port's device rule: entry points that create tensors default to the
card and refuse to fall back to the CPU."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when a CUDA device is asked for on a
    machine without CUDA (callers pass ``device="cpu"`` explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def takes_kernels(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the hand-written kernels' route: a CUDA tensor
    (the kernels launch) or a ``meta`` tensor, a dry-run's stand-in for
    one (:mod:`repro_torch.launch.dryrun`: the kernel ops' fake
    implementations give the outputs' shapes, nothing runs).  A CPU tensor
    takes the plain versions."""
    return t.is_cuda or t.is_meta
