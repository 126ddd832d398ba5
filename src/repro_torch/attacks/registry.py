"""Attack registry: name -> Attack spec, with aliases (the same names as
the reference's registry)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.attacks.base import ACCESS_LEVELS, Attack

_REGISTRY: Dict[str, Attack] = {}
_ALIASES: Dict[str, str] = {}


def register(attack: Attack) -> Attack:
    if attack.name in _REGISTRY or attack.name in _ALIASES:
        raise ValueError(f"attack {attack.name!r} already registered")
    _REGISTRY[attack.name] = attack
    return attack


def alias(name: str, target: str) -> None:
    """Register ``name`` as an alternate spelling of ``target``."""
    if name in _REGISTRY or name in _ALIASES:
        raise ValueError(f"attack {name!r} already registered")
    if target not in _REGISTRY:
        raise KeyError(f"alias target {target!r} not registered")
    _ALIASES[name] = target


def get_attack(name: str) -> Attack:
    _ensure_library()
    key = _ALIASES.get(name, name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown attack {name!r}; registered: {', '.join(registered())}"
        ) from None


def registered(access: Optional[str] = None) -> Tuple[str, ...]:
    """Registered attack names (registration order), optionally filtered
    by access level."""
    _ensure_library()
    if access is not None and access not in ACCESS_LEVELS:
        raise ValueError(f"unknown access level {access!r}")
    return tuple(
        n for n, a in _REGISTRY.items() if access is None or a.access == access
    )


def _ensure_library() -> None:
    # the library self-registers on first use; importing here (not at
    # module top) avoids a registry <-> library import cycle
    from repro_torch.attacks import library  # noqa: F401
