"""Architecture config registry: ``get_config(name)`` / ``get_smoke_config(name)``.

Each assigned architecture lives in its own module exporting ``CONFIG``
(the exact published shape, source cited) and ``smoke_config()`` (reduced
same-family variant for CPU tests).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
)

ARCHITECTURES = [
    "granite-moe-1b-a400m",
    "llama3-405b",
    "mamba2-2.7b",
    "whisper-small",
    "recurrentgemma-2b",
    "llama3.2-3b",
    "internvl2-1b",
    "qwen3-14b",
    "grok-1-314b",
    "h2o-danube-1.8b",
]

# The paper's own experiment models (logistic regression, small CNN,
# Prop-1 linear regression) are not transformer configs — they live in
# repro_torch.models.paper_models.


def _module(name: str):
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
