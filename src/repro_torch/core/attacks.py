"""Byzantine attack configuration shim over :mod:`repro_torch.attacks`.

:class:`AttackConfig` plus the ``apply_data_attack`` /
``apply_gradient_attack`` / ``byzantine_payload`` helpers the rest of
the port configures attacks with.  ``AttackConfig.name`` may be any
registered attack; the legacy names keep their strength-field mapping
(``scale`` for sign_flip/large_value, ``shift`` for alie/mean_shift) and
an explicit ``strength`` overrides either.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import attacks as engine_pkg
from repro_torch.attacks import base as attack_base
from repro_torch.attacks import engine

# attacks whose payload needs the honest per-coordinate variance
NEEDS_VARIANCE = tuple(
    n for n in engine_pkg.registered()
    if engine_pkg.get_attack(n).needs_variance
)

_SCALE_NAMES = ("sign_flip", "large_value")
_SHIFT_NAMES = ("alie", "mean_shift")


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Which attack to apply, and to which workers.

    ``alpha`` is the Byzantine fraction; workers ``0 .. ceil(alpha*m)-1``
    are Byzantine.
    """

    name: str = "none"
    alpha: float = 0.0
    scale: float = 100.0  # magnitude used by sign_flip / large_value
    num_classes: int = 10  # used by label attacks
    shift: float = 1.0  # used by alie / mean_shift
    strength: Optional[float] = None  # explicit engine strength (overrides)

    def num_byzantine(self, m: int) -> int:
        return engine.num_byzantine(self.alpha, m)

    def byzantine_mask(self, m: int, *, device="cuda") -> torch.Tensor:
        return engine.byzantine_mask(self.alpha, m, device=device)

    def resolve(self):
        """(Attack, strength) for the engine; (None, None) for 'none'."""
        if self.name == "none":
            return None, None
        atk = engine_pkg.get_attack(self.name)
        if self.strength is not None:
            return atk, self.strength
        if self.name in _SCALE_NAMES:
            return atk, self.scale
        if self.name in _SHIFT_NAMES:
            return atk, self.shift
        return atk, atk.strength

    def is_data_attack(self) -> bool:
        atk, _ = self.resolve()
        return atk is not None and atk.access == attack_base.DATA


# ---------------------------------------------------------------- data space


def label_flip(y: torch.Tensor, num_classes: int = 10) -> torch.Tensor:
    """The paper's first experiment: replace every label y with (C-1) - y."""
    return engine.corrupt_labels("label_flip", y, None, num_classes)


def random_label(y: torch.Tensor, generator: torch.Generator,
                 num_classes: int = 10) -> torch.Tensor:
    """The paper's one-round experiment: iid uniform labels."""
    return engine.corrupt_labels("random_label", y, generator, num_classes)


def apply_data_attack(cfg: AttackConfig, batch: dict, is_byzantine,
                      generator: Optional[torch.Generator] = None) -> dict:
    """Corrupt the labels of a (per-worker) batch if ``is_byzantine``."""
    if cfg.name == "none" or cfg.alpha == 0.0:
        return batch
    atk, _ = cfg.resolve()
    if atk.access != attack_base.DATA:
        return batch  # gradient-space attacks don't touch the data
    y = batch["y"]
    y_bad = engine.corrupt_labels(atk, y, generator, cfg.num_classes)
    return {**batch, "y": torch.where(torch.as_tensor(is_byzantine, device=y.device), y_bad, y)}


# ------------------------------------------------------------ gradient space


def byzantine_payload(cfg: AttackConfig, honest_mean: torch.Tensor,
                      honest_var: Optional[torch.Tensor] = None, *,
                      m: Optional[int] = None,
                      own: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      prev_agg: Optional[torch.Tensor] = None,
                      agg_history: Optional[torch.Tensor] = None,
                      staleness=None, whole=None) -> torch.Tensor:
    """The bad-row value for a gradient-space attack, given the honest
    statistics the colluders observe (engine.payload_from_stats)."""
    atk, strength = cfg.resolve()
    if atk is None:
        raise ValueError("byzantine_payload called with attack 'none'")
    return engine.payload_from_stats(
        atk, honest_mean, honest_var, m=m if m is not None else 0,
        alpha=cfg.alpha, strength=strength, own=own, generator=generator,
        prev_agg=prev_agg, agg_history=agg_history, staleness=staleness, whole=whole)


def apply_gradient_attack(cfg: AttackConfig, stacked: torch.Tensor, mask: torch.Tensor,
                          *, generator: Optional[torch.Generator] = None,
                          prev_agg: Optional[torch.Tensor] = None,
                          agg_history: Optional[torch.Tensor] = None,
                          staleness=None,
                          rnd=None,
                          row_sum=None, whole=None) -> torch.Tensor:
    """Replace Byzantine rows of a stacked per-worker tensor ``(m, ...)``;
    ``mask`` is bool ``(m,)``, True rows Byzantine; ``row_sum`` and
    ``whole`` as :func:`repro_torch.attacks.engine.apply_to_rows`'."""
    if cfg.name == "none" or cfg.alpha == 0.0:
        return stacked
    atk, strength = cfg.resolve()
    if atk.access == attack_base.DATA:
        return stacked  # data attacks corrupt samples upstream
    return engine.apply_to_rows(
        atk, stacked, mask, alpha=cfg.alpha, strength=strength,
        generator=generator, prev_agg=prev_agg, agg_history=agg_history,
        staleness=staleness, rnd=rnd, row_sum=row_sum, whole=whole)
