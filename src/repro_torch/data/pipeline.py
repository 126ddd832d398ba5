"""Worker-sharded classification data with Byzantine label corruption.

Worker model (the paper's): the data is split evenly over the m workers,
each shard drawn from a generator derived from (seed, worker) and fixed
for the whole run; Byzantine workers' labels are corrupted at source.
The LM batches of the reference wait for the LM-training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import rng
from repro_torch.core.attacks import AttackConfig, label_flip, random_label
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int = 32
    num_workers: int = 4  # m
    seed: int = 0
    d: int = 784  # feature dim


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
