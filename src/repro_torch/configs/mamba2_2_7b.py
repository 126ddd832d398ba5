"""mamba2-2.7b [arXiv:2405.21060] — SSD (state-space duality).

64L, d_model=2560, attention-free, d_ff=0, vocab=50280, ssm_state=128.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        name="mamba2-smoke",
        n_layers=2,
        d_model=128,
        vocab=256,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, conv_width=4, chunk=32),
    )
