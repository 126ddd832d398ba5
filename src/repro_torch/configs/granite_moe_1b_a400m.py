"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16H (GQA kv=8), MoE: 32 experts top-8, d_ff=512/expert,
vocab=49155.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=0,
    vocab=49155,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
    rope_theta=10000.0,
    long_context_window=8192,  # SWA variant used only for long_500k decode
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="granite-moe-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        vocab=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
        long_context_window=0,
    )
