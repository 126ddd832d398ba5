"""Synthetic datasets, drawn from ``torch.Generator``s on the CPU and then
moved to ``device`` — so a run on the card and a run on the CPU see the
same numbers.

- ``lm_batch``: learnable token streams — next token = (5·tok + 7) % vocab
  with probability 0.9, uniform noise otherwise.
- ``mnist_analog``: 10-class Gaussian mixture in 784-d with spatially
  structured class means (7x7 blobs upsampled to 28x28) — stands in for
  MNIST in the paper-replication experiments.
- ``linreg`` (Proposition 1): y = x·w* + noise with Rademacher or
  Gaussian x.

The reference draws from ``jax.random``; the two streams differ, so
parity tests feed the same numpy arrays to both packages.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import resolve


def lm_batch(gen: torch.Generator, batch: int, seq: int, vocab: int, *,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Learnable synthetic LM data, int32 (B, seq) ``tokens`` and ``labels``
    (the stream shifted by one): next token = (5·tok + 7) % vocab with
    probability 0.9, uniform noise otherwise."""
    dev = resolve(device)
    first = torch.randint(0, vocab, (batch,), generator=gen)
    noise = torch.randint(0, vocab, (seq, batch), generator=gen)
    pick = torch.rand((seq, batch), generator=gen) < 0.9
    toks = [first]
    for i in range(seq):
        toks.append(torch.where(pick[i], (5 * toks[-1] + 7) % vocab, noise[i]))
    stream = torch.stack(toks, dim=1).to(torch.int32)  # (B, seq + 1)
    return {"tokens": stream[:, :-1].to(dev), "labels": stream[:, 1:].to(dev)}


def mnist_analog(gen: torch.Generator, n: int, d: int = 784, num_classes: int = 10,
                 noise: float = 1.0, mu_seed: int = 424242, *,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """10-class Gaussian mixture standing in for MNIST.

    The class means come from the FIXED ``mu_seed`` so every worker shard
    and the test set sample the same population (the paper's iid
    setting); ``gen`` only drives the sample draw.
    """
    dev = resolve(device)
    mus = _class_means(num_classes, d, mu_seed)
    y = torch.randint(0, num_classes, (n,), generator=gen)
    x = mus[y] + noise * torch.randn(n, d, generator=gen)
    return {"x": x.to(dev), "y": y.to(dev)}


def _class_means(num_classes: int, d: int, mu_seed: int) -> torch.Tensor:
    """Class means with SPATIAL structure when d is a square image size
    (smooth low-res blobs upsampled 4x, so the CNN has conv/pool
    compatible signal), normalised to ||mu_c|| = 3."""
    gen = torch.Generator().manual_seed(mu_seed)
    side = int(round(d ** 0.5))
    if side * side == d and side % 4 == 0:
        low = torch.randn(num_classes, side // 4, side // 4, generator=gen)
        mus = low.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2).reshape(num_classes, d)
    else:
        mus = torch.randn(num_classes, d, generator=gen)
    return 3.0 * mus / torch.linalg.vector_norm(mus, dim=1, keepdim=True)


def rademacher(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform ±1 float32 entries."""
    return torch.randint(0, 2, shape, generator=gen).float() * 2.0 - 1.0


def linreg(gen: torch.Generator, n: int, d: int, sigma: float,
           features: str = "rademacher", *, device="cuda"
           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Proposition 1 data: ({"x": (n, d), "y": (n,)}, w*)."""
    dev = resolve(device)
    if features == "rademacher":
        x = rademacher(gen, (n, d))
    elif features == "gaussian":
        x = torch.randn(n, d, generator=gen)
    else:
        raise ValueError(features)
    w_star = torch.randn(d, generator=gen) / d ** 0.5
    y = x @ w_star + sigma * torch.randn(n, generator=gen)
    return {"x": x.to(dev), "y": y.to(dev)}, w_star.to(dev)
