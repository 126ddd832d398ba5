"""Kernels for the paper's aggregation hot spot.

- selection_network.py: pruned compare-exchange program generator and
  its torch executors (the kernels' plain versions)
- robust_agg.py: hand-written CUDA kernels running the programs
  (median, trimmed mean, fused) — built at first use
- ops.py: dispatch (cuda kernel / torch network / torch.sort)
- histogram_agg.py: histogram-sketch math for the approx_* aggregators
- ref.py: torch.sort oracle
"""
from repro_torch.kernels import (  # noqa: F401
    histogram_agg, ops, ref, robust_agg, selection_network)
