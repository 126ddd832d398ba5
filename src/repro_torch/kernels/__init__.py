"""Kernels for the paper's aggregation hot spot.

- selection_network.py: pruned compare-exchange program generator and
  its torch executors (the kernels' plain versions)
- select_codegen.py: launch plan and CUDA source of the median,
  trimmed-mean and fused median + trimmed-mean kernels (each program
  compiled in around csrc/select_program.cuh)
- robust_agg.py: their wrappers (one launch per up to 16 leaves) — built
  at first use or in a batch (``prepare``)
- ops.py: dispatch (cuda kernel / torch network / torch.sort)
- histogram_agg.py: histogram-sketch math for the approx_* aggregators
- moe_combine.py: the MoE combine and its backward (one kernel each),
  which the MoE layer calls
- ref.py: torch.sort oracle
"""
from repro_torch.kernels import (  # noqa: F401
    histogram_agg, moe_combine, ops, ref, robust_agg, select_codegen, selection_network)
