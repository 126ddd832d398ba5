"""Weight carrier between the reference's parameter dicts and the port's.

The port keeps the reference's parameter layout (HWIO conv weights,
``fc1`` rows in HWC-flatten order), so conversion checks keys, shapes
and dtypes and moves tensors; it never reshapes.  ``linreg`` parameters
are a bare (d,) vector in both packages.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve

_KEYS = {
    "logreg": ("w", "b"),
    "cnn": ("c1", "b1", "c2", "b2", "fc1", "bf1", "fc2", "bf2"),
}


def _expected_shapes(name: str, p: Dict[str, np.ndarray]) -> Dict[str, Tuple[int, ...]]:
    """The shapes the model's layout implies, from its free dimensions."""
    if name == "logreg":
        d, c = p["w"].shape
        return {"w": (d, c), "b": (c,)}
    width = p["c1"].shape[-1]
    hidden, classes = p["fc2"].shape
    return {"c1": (3, 3, 1, width), "b1": (width,), "c2": (3, 3, width, width),
            "b2": (width,), "fc1": (7 * 7 * width, hidden), "bf1": (hidden,),
            "fc2": (hidden, classes), "bf2": (classes,)}


def _tensor(name: str, a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"{name}: expected float32, got {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(device)  # a copy: never aliased


def from_reference(name: str, params_np, device="cuda"
                   ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's parameters (numpy arrays) as the port's tensors."""
    dev = resolve(device)
    if name == "linreg":
        if np.ndim(params_np) != 1:
            raise ValueError(f"linreg: expected a (d,) vector, got shape {np.shape(params_np)}")
        return _tensor("linreg", params_np, dev)
    if name not in _KEYS:
        raise ValueError(f"unknown model {name!r}; want logreg, cnn or linreg")
    if set(params_np) != set(_KEYS[name]):
        raise KeyError(f"{name}: expected keys {sorted(_KEYS[name])}, got {sorted(params_np)}")
    for k in ("w", "c1", "fc2"):
        if k in params_np and np.ndim(params_np[k]) != (4 if k == "c1" else 2):
            raise ValueError(f"{name}: {k} has shape {np.shape(params_np[k])}")
    want = _expected_shapes(name, params_np)
    for k in _KEYS[name]:
        if tuple(np.shape(params_np[k])) != want[k]:
            raise ValueError(f"{name}: {k} has shape {np.shape(params_np[k])}, "
                             f"expected {want[k]}")
    return {k: _tensor(f"{name}.{k}", params_np[k], dev) for k in _KEYS[name]}


def to_reference(params) -> Union[np.ndarray, Dict[str, np.ndarray]]:
    """The port's parameters as numpy arrays in the reference's layout."""
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
