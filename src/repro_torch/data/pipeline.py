"""Worker-sharded data with Byzantine label corruption.

Worker model (the paper's): the global batch is split evenly over the m
workers, each shard drawn from a generator derived from (seed, worker) —
for LM batches (seed, step, worker) — and Byzantine workers' labels are
corrupted at source.  ``make_lm_batch`` lays worker w's shard out as rows
[w·B/m : (w+1)·B/m] of the global batch, the rows worker w of the
trainer's worker axis computes its gradient on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import torch

from repro_torch import rng
from repro_torch.core.attacks import AttackConfig, label_flip, random_label
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str = "lm"  # lm|mnist|linreg
    vocab: int = 32000  # LM batches
    seq_len: int = 1024
    global_batch: int = 32
    num_workers: int = 4  # m
    seed: int = 0
    d: int = 784  # classification/regression feature dim
    sigma: float = 0.5  # linreg noise


def _corrupt_labels(cfg: DataConfig, attack: Optional[AttackConfig],
                    labels: torch.Tensor, worker: int,
                    generator: torch.Generator) -> torch.Tensor:
    if attack is None or attack.alpha <= 0:
        return labels
    if worker >= attack.num_byzantine(cfg.num_workers):
        return labels
    if attack.name == "label_flip":
        return label_flip(labels, attack.num_classes)
    if attack.name == "random_label":
        return random_label(labels, generator, attack.num_classes)
    return labels  # gradient attacks happen at the aggregation point


def make_lm_batch(cfg: DataConfig, step: int, attack: Optional[AttackConfig] = None,
                  *, device="cuda") -> Dict[str, torch.Tensor]:
    """One global LM batch (B, S) with per-worker provenance: worker w's
    rows come from the generator of (seed, step, w), and a Byzantine
    worker's labels are corrupted by ``label_flip`` / ``random_label``
    (its generator (seed, step, w, 999))."""
    from repro_torch.data.synthetic import lm_batch

    dev = resolve(device)
    per = cfg.global_batch // cfg.num_workers
    parts = []
    for w in range(cfg.num_workers):
        b = lm_batch(rng.generator(cfg.seed, step, w), per, cfg.seq_len, cfg.vocab,
                     device="cpu")
        if attack is not None and attack.name in ("label_flip", "random_label"):
            b["labels"] = _corrupt_labels(cfg, attack, b["labels"], w,
                                          rng.generator(cfg.seed, step, w, 999))
        parts.append(b)
    return {k: torch.cat([p[k] for p in parts]).to(dev) for k in ("tokens", "labels")}


def make_classification_shards(cfg: DataConfig, attack: Optional[AttackConfig] = None,
                               *, device="cuda") -> Dict[str, torch.Tensor]:
    """Fixed worker-sharded classification dataset, leaves (m, n, ...):
    data drawn once, Byzantine workers hold corrupted labels permanently."""
    from repro_torch.data.synthetic import mnist_analog

    dev = resolve(device)
    n_per = cfg.global_batch // cfg.num_workers
    xs, ys = [], []
    for w in range(cfg.num_workers):
        d = mnist_analog(rng.generator(cfg.seed, w), n_per, d=cfg.d, device="cpu")
        y = _corrupt_labels(cfg, attack, d["y"], w, rng.generator(cfg.seed, w, 999))
        xs.append(d["x"])
        ys.append(y)
    return {"x": torch.stack(xs).to(dev), "y": torch.stack(ys).to(dev)}


def lm_iterator(cfg: DataConfig, attack: Optional[AttackConfig] = None,
                start_step: int = 0, *, device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """``make_lm_batch`` at ``start_step``, ``start_step + 1``, ... without end."""
    step = start_step
    while True:
        yield make_lm_batch(cfg, step, attack, device=device)
        step += 1
