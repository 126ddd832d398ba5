"""Attack resolution shared by the round programs.

Only :func:`resolve_attack` and :func:`resolve_attack_checked` so far:
the scheduled round driver keys its per-attack round functions on them.
The reference's communication-strategy registry and ``CommBudget`` come
with the multi-GPU port.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.attacks import base as attack_base


def resolve_attack(attack) -> Tuple[Optional[object], Optional[float], Optional[float]]:
    """Normalize an attack argument to ``(Attack spec, alpha, strength)``.

    Accepts None, a registered name (alpha stays None — the caller
    supplies it), an Attack spec, or an AttackConfig (its ``resolve()``
    maps the legacy scale/shift fields onto the engine's strength).
    ``(None, None, None)`` means "no attack".
    """
    if attack is None:
        return None, None, None
    from repro_torch.attacks import engine

    if isinstance(attack, str):
        if attack == "none":
            return None, None, None
        spec = engine.as_attack(attack)
        return spec, None, spec.strength
    if isinstance(attack, attack_base.Attack):
        return attack, None, attack.strength
    spec, strength = attack.resolve()  # AttackConfig (duck-typed)
    if spec is None or attack.alpha == 0.0:
        return None, None, None
    return spec, attack.alpha, strength


def resolve_attack_checked(attack):
    """:func:`resolve_attack`, rejecting a non-None attack without a
    Byzantine fraction (a bare name or spec): running clean while
    reporting an attack name would be a measurement trap."""
    spec, alpha, strength = resolve_attack(attack)
    if spec is not None and alpha is None:
        raise ValueError(
            f"attack {spec.name!r} given without a Byzantine fraction; pass an "
            "AttackConfig (its alpha field sets the Byzantine cut)")
    return spec, alpha, strength
