"""The benchmark's inputs, made on the device from the run's seed: the
weights of a configuration and the token batches of a traffic mix.

Tokens follow a copy of the port's synthetic LM rule
(``repro_torch.data.synthetic.lm_batch``): the next token is
``(mult·tok + add) % vocab`` with probability ``keep``, a uniform draw
otherwise, so a model can learn the stream and its loss falls.  The
stream is drawn in bulk: between two uniform draws ("resets") a token is
the affine map iterated k times from the last reset, ``a_k·t + b_k``, so
one ``cummax`` finds every position's last reset.  A mix of ``ring``
distinct steps is made once in set-up; step i of a run takes batch ``i %
ring``.  Worker w's rows are rows [w·b, (w+1)·b) of a step's batch, and
a data attack (``label_flip``) rewrites the Byzantine workers' labels.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, List

import torch

from chipbench.bench import subseed
from chipbench.reference.train import num_byzantine


def _affine_powers(n: int, vocab: int, mult: int, add: int, device) -> tuple:
    """(a_k, b_k) for k = 0..n: the map t -> mult·t + add (mod vocab)
    iterated k times is t -> a_k·t + b_k."""
    a, b = [1], [0]
    for _ in range(n):
        a.append(a[-1] * mult % vocab)
        b.append((b[-1] * mult + add) % vocab)
    return (torch.tensor(a, dtype=torch.int64, device=device),
            torch.tensor(b, dtype=torch.int64, device=device))


def token_streams(seed: int, rows: int, length: int, vocab: int, data: Dict,
                  device) -> torch.Tensor:
    """(rows, length + 1) int64 token streams drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "tokens"))
    first = torch.randint(0, vocab, (rows, 1), generator=gen, device=device)
    noise = torch.randint(0, vocab, (rows, length), generator=gen, device=device)
    keep = torch.rand((rows, length), generator=gen, device=device) < data["keep"]
    value = torch.cat([first, noise], 1)  # the value a reset at each position takes
    reset = torch.cat([torch.ones((rows, 1), dtype=torch.bool, device=device), ~keep], 1)
    pos = torch.arange(length + 1, device=device).expand(rows, -1)
    last = torch.cummax(torch.where(reset, pos, torch.zeros_like(pos)), 1).values
    a, b = _affine_powers(length, vocab, data["mult"], data["add"], device)
    k = pos - last
    return (a[k] * torch.gather(value, 1, last) + b[k]) % vocab


def make_ring(traffic: Dict, vocab: int, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The mix's ``ring`` distinct step batches, each {"tokens", "labels"}
    int32 (workers·batch_per_worker, seq_len); a data attack's Byzantine
    workers' labels rewritten."""
    m, b, s = traffic["workers"], traffic["batch_per_worker"], traffic["seq_len"]
    n = traffic["ring"]
    stream = token_streams(seed, n * m * b, s, vocab, traffic["data"], device)
    stream = stream.to(torch.int32).view(n, m * b, s + 1)
    attack = traffic.get("attack") or {}
    ring = []
    for i in range(n):
        tokens, labels = stream[i, :, :-1].contiguous(), stream[i, :, 1:].contiguous()
        if attack.get("name") == "label_flip":
            q = num_byzantine(attack["alpha"], m)
            labels[:q * b] = (vocab - 1) - labels[:q * b]
        ring.append({"tokens": tokens, "labels": labels})
    return ring


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def make_leaf(ref: ModuleType, model: Dict, seed: int, path: str, device) -> torch.Tensor:
    """One weight leaf of the configuration ``model`` (the configuration
    file's ``port`` group), drawn on ``device`` from the generator of
    (seed, path) in one call, in float32, and cast to the model's dtype:
    N(0, std²) with the shape and std of the reference module ``ref``'s
    ``param_specs``."""
    shape, std = ref.param_specs(model)[path]
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights", path))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(getattr(torch, model["dtype"]))
