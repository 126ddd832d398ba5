"""``torch.sort`` oracle for the robust-aggregation kernels.

Sort the m per-worker rows per coordinate, then
- median: middle row (odd m) or the f32 mean of the two middle rows;
- trimmed mean: f32 mean of rows b..m-b-1 where b = floor(beta*m);
result cast back to the input dtype.
"""
from __future__ import annotations

import torch


def median_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (m, n) -> (n,) coordinate-wise median."""
    m = x.shape[0]
    s = torch.sort(x, dim=0).values
    if m % 2 == 1:
        return s[m // 2]
    lo = s[m // 2 - 1].float()
    hi = s[m // 2].float()
    return ((lo + hi) * 0.5).to(x.dtype)


def trimmed_mean_ref(x: torch.Tensor, beta: float) -> torch.Tensor:
    """x: (m, n) -> (n,) coordinate-wise beta-trimmed mean."""
    m = x.shape[0]
    b = int(beta * m)
    if 2 * b >= m:
        raise ValueError(f"trim count 2*{b} >= m={m}")
    s = torch.sort(x.float(), dim=0).values
    return s[b: m - b].mean(dim=0).to(x.dtype)
