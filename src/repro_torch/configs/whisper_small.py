"""whisper-small [arXiv:2212.04356] — encoder-decoder audio model.

12L (12 enc + 12 dec), d_model=768, 12H (kv=12), d_ff=3072, vocab=51865.
The mel-spectrogram + conv feature extractor is a STUB: input_specs()
provides precomputed frame embeddings (B, 1500, 768) — see DESIGN.md.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    n_enc_layers=12,
    cross_attention=True,
    frontend="audio",
    n_frontend_tokens=1500,
    rope_theta=10000.0,
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="whisper-smoke",
        n_layers=2,
        n_enc_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=256,
        n_frontend_tokens=32,
    )
