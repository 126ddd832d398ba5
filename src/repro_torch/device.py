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
