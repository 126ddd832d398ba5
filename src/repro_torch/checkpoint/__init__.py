"""Checkpointing of tensor trees (npy files + manifest.json)."""
from repro_torch.checkpoint.checkpoint import load_extra, restore, save  # noqa: F401
