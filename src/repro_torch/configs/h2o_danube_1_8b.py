"""h2o-danube-1.8b [arXiv:2401.16818] — llama+mistral mix with SWA.

24L, d_model=2560, 32H (GQA kv=8), d_ff=6912, vocab=32000,
native sliding-window attention (4096).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,  # native SWA — long_500k runs without a variant
    rope_theta=10000.0,
    source="arXiv:2401.16818",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="h2o-danube-smoke",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=256,
        sliding_window=16,
    )
