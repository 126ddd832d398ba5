"""grok-1-314b [hf:xai-org/grok-1] — MoE: 8 experts, top-2.

64L, d_model=6144, 48H (GQA kv=8), d_ff=32768/expert, vocab=131072.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab=131072,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768),
    rope_theta=10000.0,
    long_context_window=8192,  # SWA variant used only for long_500k decode
    source="hf:xai-org/grok-1",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="grok-1-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        vocab=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128),
        long_context_window=0,
    )
