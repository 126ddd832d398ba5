"""The attack, the coordinate-wise aggregators and AdamW, plainly, on
float32 rows (m, n): frozen from the port's ``attacks/library.py``
(ALIE), ``kernels/selection_network.py``'s definitions of the median and
the trimmed mean, and ``optim/optimizers.py`` (AdamW)."""
from __future__ import annotations

import torch

VAR_EPS = 1e-12  # under the square root of the honest variance


def alie(rows: torch.Tensor, q: int, shift: float) -> torch.Tensor:
    """"A little is enough": rows 0 .. q-1 replaced by the honest rows'
    mean minus ``shift`` honest standard deviations (population variance),
    coordinate by coordinate; ``rows`` is rewritten in place."""
    if q == 0:
        return rows
    honest = rows[q:]
    mean = honest.mean(0)
    var = ((honest - mean) ** 2).mean(0)
    rows[:q] = mean - shift * torch.sqrt(var + VAR_EPS)
    return rows


def median(rows: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of (m, n); the mean of the two middle values
    for even m."""
    m = rows.shape[0]
    s = torch.sort(rows, dim=0).values
    if m % 2:
        return s[m // 2]
    return (s[m // 2 - 1] + s[m // 2]) * 0.5


def trimmed_mean(rows: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise mean of the m - 2·trim middle values."""
    m = rows.shape[0]
    s = torch.sort(rows, dim=0).values
    return s[trim:m - trim].sum(0) / (m - 2 * trim)


def aggregate(rows: torch.Tensor, method: str, beta: float) -> torch.Tensor:
    if method == "median":
        return median(rows)
    if method == "trimmed_mean":
        return trimmed_mean(rows, int(beta * rows.shape[0]))
    if method == "mean":
        return rows.mean(0)
    raise ValueError(f"the reference has no aggregator {method!r}")


def adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, step: int,
          opt: dict) -> None:
    """One AdamW step of leaf ``p`` (float32) with gradient ``g`` at the
    0-based ``step``, the moments ``m``, ``v`` and ``p`` updated in place."""
    b1, b2, eps, lr, wd = opt["b1"], opt["b2"], opt["eps"], opt["lr"], opt["weight_decay"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).add_(g * g, alpha=1 - b2)
    mh = m / (1 - b1 ** (step + 1))
    vh = v / (1 - b2 ** (step + 1))
    p.sub_(lr * (mh / (torch.sqrt(vh) + eps) + wd * p))
