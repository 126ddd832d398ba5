"""Synthetic data and worker shards (torch generators)."""
