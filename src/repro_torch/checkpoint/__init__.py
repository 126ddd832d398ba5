"""Checkpointing of tensor trees (npy files + manifest.json)."""
