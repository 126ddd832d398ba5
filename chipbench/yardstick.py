"""What a run is measured against: the card's published peaks and the
bytes a step's aggregation has to move, counted from the shapes of the
configuration's reference module (``param_specs``; its model FLOPs are
the module's ``model_flops_per_step``).

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit (the card's
``power.limit`` is printed beside every run).
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict

#: dense bf16 / fp16 tensor-core peak, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def param_count(ref: ModuleType, model: Dict) -> int:
    """The weights of ``model`` by the reference module ``ref``."""
    total = 0
    for shape, _ in ref.param_specs(model).values():
        n = 1
        for x in shape:
            n *= x
        total += n
    return total


def aggregate_bytes_per_step(ref: ModuleType, model: Dict, traffic: Dict) -> int:
    """Bytes the coordinate-wise aggregation of one step has to move: each
    of the m workers' gradient rows read once and the aggregate written
    once, in the parameters' dtype."""
    return (traffic["workers"] + 1) * param_count(ref, model) * _DTYPE_BYTES[model["dtype"]]
