"""Deterministic seed derivation — the port's counterpart of
``jax.random.fold_in``.

torch generators cannot reproduce JAX's threefry streams, so parity with
the reference is held by feeding both packages the same numpy data; what
this module guarantees is that the port is deterministic per (seed,
round, worker, ...), on every device.
"""
from __future__ import annotations

import hashlib

import torch


def generator(seed: int, *data: int, device="cpu") -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with a 63-bit hash
    of ``seed`` and the integers ``data``."""
    h = hashlib.blake2b(repr((int(seed),) + tuple(int(d) for d in data)).encode(),
                        digest_size=8)
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h.digest(), "little") & (2 ** 63 - 1))
