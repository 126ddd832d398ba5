"""internvl2-1b [arXiv:2404.16821] — InternViT + LM decoder (VLM).

24L, d_model=896, 14H (GQA kv=2), d_ff=4864, vocab=151655.
The InternViT vision encoder + projector is a STUB: input_specs()
provides precomputed patch embeddings (B, 256, 896) — see DESIGN.md.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    frontend="vision",
    n_frontend_tokens=256,
    rope_theta=10000.0,
    long_context_window=8192,  # SWA variant used only for long_500k decode
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="internvl2-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        n_frontend_tokens=8,
        long_context_window=0,
    )
