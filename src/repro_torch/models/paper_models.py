"""The paper's own experiment models (Section 7), as plain functions on
dicts of tensors.

- multi-class logistic regression (paper Tables 2 and 4);
- a small convolutional network (paper Table 3);
- linear regression (Proposition 1's running example).

Parameters keep the reference's layout, so gradients compare leaf for
leaf with it (see models/convert.py): the CNN's conv weights are HWIO
and ``fc1``'s rows follow the HWC flatten of the pooled (7, 7, width)
activation.  ``cnn_logits`` permutes to NCHW/OIHW for ``conv2d`` and
back to NHWC before the flatten.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------- logistic


def init_logreg(d: int = 784, num_classes: int = 10, *, device="cuda") -> Params:
    dev = resolve(device)
    return {
        "w": torch.zeros((d, num_classes), dtype=torch.float32, device=dev),
        "b": torch.zeros((num_classes,), dtype=torch.float32, device=dev),
    }


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None].long())[:, 0]
    return (logz - gold).mean()


def logreg_loss(params: Params, batch, l2: float = 1e-4) -> torch.Tensor:
    logits = batch["x"] @ params["w"] + params["b"]
    reg = 0.5 * l2 * (params["w"] ** 2).sum()
    return _xent(logits, batch["y"]) + reg


def logreg_accuracy(params: Params, batch) -> torch.Tensor:
    logits = batch["x"] @ params["w"] + params["b"]
    return (logits.argmax(dim=-1) == batch["y"]).float().mean()


# ------------------------------------------------------------------ cnn


def init_cnn(gen: torch.Generator, num_classes: int = 10, width: int = 16, *,
             device="cuda") -> Params:
    """Small convnet for 28x28x1 inputs: conv3x3 -> pool -> conv3x3 ->
    pool -> fc -> fc.  He-normal weights drawn on the CPU from ``gen``."""
    dev = resolve(device)

    def he(shape, fan):
        return ((2.0 / fan) ** 0.5 * torch.randn(shape, generator=gen)).to(dev)

    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    return {
        "c1": he((3, 3, 1, width), 9),
        "b1": zeros(width),
        "c2": he((3, 3, width, width), 9 * width),
        "b2": zeros(width),
        "fc1": he((7 * 7 * width, 64), 7 * 7 * width),
        "bf1": zeros(64),
        "fc2": he((64, num_classes), 64),
        "bf2": zeros(num_classes),
    }


def _conv(h: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # SAME padding for a 3x3 stride-1 kernel; HWIO -> OIHW
    y = F.conv2d(h, w_hwio.permute(3, 2, 0, 1), padding=1)
    return F.relu(y + b[:, None, None])


def cnn_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 784) flattened -> logits."""
    b = x.shape[0]
    img = x.reshape(b, 1, 28, 28)  # NHWC with C=1 has the same memory order
    h = F.max_pool2d(_conv(img, params["c1"], params["b1"]), 2)
    h = F.max_pool2d(_conv(h, params["c2"], params["b2"]), 2)
    h = h.permute(0, 2, 3, 1).reshape(b, -1)  # HWC flatten, as the reference
    h = F.relu(h @ params["fc1"] + params["bf1"])
    return h @ params["fc2"] + params["bf2"]


def cnn_loss(params: Params, batch) -> torch.Tensor:
    return _xent(cnn_logits(params, batch["x"]), batch["y"])


def cnn_accuracy(params: Params, batch) -> torch.Tensor:
    return (cnn_logits(params, batch["x"]).argmax(dim=-1) == batch["y"]).float().mean()


# --------------------------------------------------------------- linreg


def init_linreg(d: int, *, device="cuda") -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=resolve(device))


def linreg_loss(w: torch.Tensor, batch) -> torch.Tensor:
    return 0.5 * ((batch["x"] @ w - batch["y"]) ** 2).mean()
