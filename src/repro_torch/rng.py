"""Deterministic random numbers — the port's counterpart of
``jax.random.fold_in``.

torch generators cannot reproduce JAX's threefry streams, so parity with
the reference is held by feeding both packages the same numpy data; what
this module guarantees is that the port is deterministic per (seed,
round, worker, ...), on every device.

- :func:`generator` — a ``torch.Generator`` seeded from :func:`fold`,
  a hash of (seed, data...), for draws made once per round or chunk;
- :func:`normal` / :func:`uniform` — counter-based normal and uniform
  draws keyed by (seed, stream tag, id, element index), vectorised over a
  whole tensor of ids on their device.  The virtual clients of
  :mod:`repro_torch.fed.population` draw their shards from ``normal``, and
  the federated int8 codec its dither from ``uniform``: a client's numbers
  are a pure function of (seed, client id), whichever chunk it is computed
  in, and a chunk of 512 clients is one batch of elementwise ops instead
  of 512 generators.
"""
from __future__ import annotations

import hashlib
import math

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def fold(seed: int, *data: int) -> int:
    """A 63-bit seed hashed from ``seed`` and the integers ``data`` (the
    counterpart of nested ``fold_in``s)."""
    h = hashlib.blake2b(repr((int(seed),) + tuple(int(d) for d in data)).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def generator(seed: int, *data: int, device="cpu") -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded with
    ``fold(seed, *data)``."""
    return torch.Generator(device=device).manual_seed(fold(seed, *data))


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for 32-bit values held in int64, split so that
    no product exceeds 2^49 (int64 never overflows, on any device)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit avalanche hash (``lowbias32``: xorshift-multiply rounds) of
    a Python int or an int64 tensor of 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _key(seed: int, tag: int) -> int:
    s = int(seed) & (2 ** 64 - 1)
    return _mix32(_mix32(_mix32(s & _M32) ^ (s >> 32)) ^ (int(tag) & _M32))


def _bits(seed: int, tag: int, ids: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """(k, c) 32-bit hashes of (seed, tag, ids[i], counters[j]) as int64."""
    keys = _mix32((ids.to(torch.int64) & _M32) ^ _key(seed, tag))[:, None]
    ctr = _mix32(_mul32(counters.to(torch.int64), _GOLDEN))[None, :]
    return _mix32(_mix32(keys ^ ctr) ^ keys)


def normal(seed: int, tag: int, ids: torch.Tensor, count: int) -> torch.Tensor:
    """``(len(ids), count)`` float32 standard normals on ``ids``' device.

    Element ``j`` of row ``i`` depends only on (seed, tag, ids[i], j): two
    32-bit hashes give two uniforms in (0, 1) with 24-bit resolution, and
    Box-Muller turns each pair into two normals.  The integers are the
    same on every device; the transform runs in float64 and is rounded
    once to float32, so the CPU and the card agree to the last bit unless
    their float64 log/cos/sin differ across a float32 rounding boundary.
    """
    pairs = (count + 1) // 2
    ctr = torch.arange(2 * pairs, dtype=torch.int64, device=ids.device)
    h = _bits(seed, tag, ids, ctr)
    u = ((h >> 8).to(torch.float64) + 0.5) * (1.0 / (1 << 24))
    u1, u2 = u[:, 0::2], u[:, 1::2]
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    z = torch.stack((r * torch.cos(theta), r * torch.sin(theta)), dim=-1)
    return z.reshape(ids.shape[0], 2 * pairs)[:, :count].to(torch.float32)


def uniform(seed: int, tag: int, ids: torch.Tensor, count: int) -> torch.Tensor:
    """``(len(ids), count)`` float32 uniforms in [0, 1) on ``ids``' device,
    with 24-bit resolution (exact in float32, the same bits on every
    device).  Element ``j`` of row ``i`` depends only on (seed, tag,
    ids[i], j)."""
    ctr = torch.arange(count, dtype=torch.int64, device=ids.device)
    h = _bits(seed, tag, ids, ctr)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
