"""Synthetic data and worker shards (torch generators)."""
from repro_torch.data import pipeline, synthetic  # noqa: F401
from repro_torch.data.pipeline import DataConfig  # noqa: F401
