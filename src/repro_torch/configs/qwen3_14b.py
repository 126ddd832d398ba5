"""qwen3-14b [hf:Qwen/Qwen3-8B family] — qk_norm, GQA.

40L, d_model=5120, 40H (GQA kv=8), d_ff=17408, vocab=151936.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    long_context_window=8192,  # SWA variant used only for long_500k decode
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="qwen3-smoke",
        n_layers=2,
        d_model=160,
        n_heads=5,
        n_kv_heads=1,
        d_ff=384,
        vocab=512,
        long_context_window=0,
    )
