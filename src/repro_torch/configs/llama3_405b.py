"""llama3-405b [arXiv:2407.21783].

126L, d_model=16384, 128H (GQA kv=8, head_dim=128), d_ff=53248,
vocab=128256.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=500000.0,
    long_context_window=8192,  # SWA variant used only for long_500k decode
    source="arXiv:2407.21783",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="llama3-405b-smoke",
        n_layers=2,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab=512,
        long_context_window=0,
    )
