"""Compatibility path — Algorithm 2 lives in :mod:`repro_torch.rounds`
(``rounds.one_round``: the vmap path and the streaming path; the
τ-interpolation between Algorithm 1 and Algorithm 2 is
``rounds.local_update``).  This module keeps the reference's historical
import path ``core.one_round``."""
from __future__ import annotations

from repro_torch.rounds.one_round import (  # noqa: F401
    OneRoundConfig,
    make_gd_local_solver,
    one_round,
    one_round_streaming,
    quadratic_local_solver,
)

__all__ = [
    "OneRoundConfig",
    "one_round",
    "one_round_streaming",
    "quadratic_local_solver",
    "make_gd_local_solver",
]
