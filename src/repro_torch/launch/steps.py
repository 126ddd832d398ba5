"""The serving half of the reference's ``repro.launch.steps``: prefill and
decode steps, and the continuous-batching slot pool under
:mod:`repro_torch.serve.engine`.

The reference jits each step on a mesh; here a step is a plain function
on tensors on one device, run eagerly.  Its pool is a vmap of batch-1
decodes over a leading slot axis, because a batched cache shares one
``kpos`` across its rows.  The port batches the slots directly instead:
the pool's caches carry the slot axis as their batch axis and a position
per slot (``kpos`` (n_layers, slots, eff)), and one tick is ONE batched
decode of every slot, each at its own position, updating the pool in
place.  A slot's tokens are the same as in a batch-1 decode (pinned in
tests/test_torch_serve.py).

The training half (``make_train_step``, FSDP, ``input_specs``) waits for
ROADMAP queue A items 6 and 8.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, kv_block: int = 1024,
                      cache_len: Optional[int] = None) -> Callable:
    """``step(params, tokens) -> (last-token logits, cache)``."""

    def step(params, tokens):
        with torch.no_grad():
            return T.prefill(params, tokens, cfg, kv_block=kv_block, cache_len=cache_len)

    return step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``step(params, token, cache, pos) -> (logits, cache)``, the cache
    updated in place."""

    def step(params, token, cache, pos):
        with torch.no_grad():
            return T.decode_step(params, token, cache, pos, cfg)

    return step


def make_slot_prefill_step(cfg: ModelConfig, cache_len: int) -> Callable:
    """Batch-1 prefill at a fixed prompt bucket -> (last-token logits
    (1, 1, V), a slot cache sized ``cache_len``)."""
    return make_prefill_step(cfg, kv_block=0, cache_len=cache_len)


def make_decode_pool_step(cfg: ModelConfig) -> Callable:
    """``tick(params, tokens (S,) or (S, 1[, 1]), pool, pos (S,)) ->
    (next_tokens (S,) int32, pool)``: one greedy decode step of every slot
    at its own position, the pool updated in place.  Idle slots decode
    garbage against their masked caches; the engine ignores their outputs
    and every admit replaces a slot's cache wholesale."""

    def tick(params, tokens, pool, pos):
        with torch.no_grad():
            logits, pool = T.decode_step(params, tokens.reshape(-1, 1), pool, pos, cfg)
        return torch.argmax(logits[:, 0, :].float(), dim=-1).to(torch.int32), pool

    return tick


def make_slot_admit_step() -> Callable:
    """``admit(pool, one, slot) -> pool``: copy a freshly prefilled batch-1
    cache (:func:`transformer.prefill`'s layout) into slot ``slot`` of the
    pool, in place."""

    def admit(pool, one, slot: int):
        dst, src = pool["blocks"][T.LAYER], one["blocks"][T.LAYER]
        dst["k"][:, slot].copy_(src["k"][:, 0])
        dst["v"][:, slot].copy_(src["v"][:, 0])
        dst["kpos"][:, slot].copy_(src["kpos"])
        return pool

    return admit


def init_slot_pool(cfg: ModelConfig, slots: int, cache_len: int, device="cuda"):
    """Empty pool caches: k/v (n_layers, slots, eff, KV, hd), kpos
    (n_layers, slots, eff) = -1, so an un-admitted slot attends to nothing."""
    one = T.init_cache(cfg, slots, cache_len, device=device)["blocks"][T.LAYER]
    kpos = one["kpos"][:, None, :].expand(-1, slots, -1).contiguous()
    return {"blocks": {T.LAYER: {"k": one["k"], "kpos": kpos, "v": one["v"]}}}
