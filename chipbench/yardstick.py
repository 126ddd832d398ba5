"""What a run is measured against: the card's published peaks and the
work a step has to do, counted from the configuration's shapes alone.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit (the card's
``power.limit`` is printed beside every run).
"""
from __future__ import annotations

from typing import Dict

from chipbench.reference import model as ref_model

#: dense bf16 / fp16 tensor-core peak, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def matmul_params_per_token(model: Dict) -> int:
    """Weights a token is multiplied by in the forward pass: the attention
    projections, the dense FFN or the router and the top-k experts' FFNs,
    and the lm head (the embedding is a lookup)."""
    d, h, kv, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], ref_model.head_dim(model)
    per_layer = d * h * hd * 2 + d * kv * hd * 2
    moe = model.get("moe")
    if moe:
        per_layer += d * moe["num_experts"] + moe["top_k"] * 3 * d * moe["d_expert"]
    else:
        per_layer += 3 * d * model["d_ff"]
    return model["n_layers"] * per_layer + d * model["vocab"]


def attention_pairs(seq: int, window: int) -> int:
    """(query, key) pairs a causal sequence of ``seq`` tokens scores, a key
    at most ``window`` - 1 positions back (``window`` 0: all before)."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def model_flops_per_step(model: Dict, traffic: Dict) -> float:
    """A training step's model FLOPs: 6 per matmul weight a token meets,
    and 12 per causal (query, key) pair and head dimension (QKᵀ and PV,
    forward and backward), over every worker's tokens.  The recompute of
    checkpointed layers and the experts' capacity padding are not work
    the model needs, and are not counted."""
    seqs = traffic["workers"] * traffic["batch_per_worker"]
    s = traffic["seq_len"]
    attn = (12 * attention_pairs(s, model.get("sliding_window", 0))
            * model["n_heads"] * ref_model.head_dim(model) * model["n_layers"])
    return seqs * (6.0 * matmul_params_per_token(model) * s + attn)


def param_count(model: Dict) -> int:
    total = 0
    for shape, _ in ref_model.param_specs(model).values():
        n = 1
        for x in shape:
            n *= x
        total += n
    return total


def aggregate_bytes_per_step(model: Dict, traffic: Dict) -> int:
    """Bytes the coordinate-wise aggregation of one step has to move: each
    of the m workers' gradient rows read once and the aggregate written
    once, in the parameters' dtype."""
    return (traffic["workers"] + 1) * param_count(model) * _DTYPE_BYTES[model["dtype"]]
