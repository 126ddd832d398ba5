"""recurrentgemma-2b [arXiv:2402.19427] — RG-LRU + local attention, 1:2.

26L, d_model=2560, 10H (GQA kv=1, MQA), d_ff=7680, vocab=256000.
Pattern: (rec, rec, attn) with local attention window 2048.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    hybrid_pattern=("rec", "rec", "attn"),
    local_window=2048,
    rope_theta=10000.0,
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="recurrentgemma-smoke",
        n_layers=5,  # exercises super-block scan (1×pattern) + tail (2 rec)
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab=256,
        local_window=16,
    )
