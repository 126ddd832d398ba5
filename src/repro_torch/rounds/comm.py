"""Communication accounting and attack resolution shared by the round
programs.

- :class:`StrategySpec` — one collective strategy's contract: the
  per-device collective bytes of one aggregation round (a closed form in
  gradient size, worker count, dtype and sketch bins, and the same cost
  as a human-readable formula), whether it computes the exact estimator,
  and the highest attack access level it can reproduce;
- the strategy registry (:func:`register_strategy`,
  :func:`get_strategy_spec`, :func:`registered_strategies`) — gather,
  bucketed, rs, hierarchical, chunked and psum, with the reference's byte
  models;
- :func:`validate_attack_strategy` — rejects, at build time, an attack
  that needs more gradient access than a strategy materializes;
- :class:`CommBudget` — bytes communicated over a run:
  ``bytes_per_round(strategy) x rounds``, scaled by a
  :mod:`repro_torch.rounds.compression` scheme's payload ratio;
- :func:`resolve_attack` / :func:`resolve_attack_checked` — the attack
  argument of every round program, normalized.

Byte counts are per device and count collective payload only: an
accounting model for comparing strategies, not a wire measurement.  The
strategies' collective bodies are in :mod:`repro_torch.core.distributed`
(over the in-process axes or a ``torch.distributed`` process group);
their registry entries and byte models are here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

from repro_torch.attacks import base as attack_base

BytesFn = Callable[[int, int, int, int], int]  # (num_params, m, dtype_bytes, nbins)


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """One collective strategy's communication and capability contract.

    ``bytes_fn(num_params, m, dtype_bytes, nbins)`` returns the per-device
    collective bytes of one aggregation round; ``bytes_formula`` is the
    same cost as a formula.  ``max_access`` is the highest attack access
    level the strategy can reproduce (:func:`validate_attack_strategy`).
    """

    name: str
    exact: bool
    max_access: str
    bytes_formula: str
    bytes_fn: BytesFn
    summary: str = ""

    def __post_init__(self):
        attack_base.access_rank(self.max_access)  # validate

    def bytes_per_round(self, num_params: int, m: int,
                        dtype_bytes: int = 4, nbins: int = 256,
                        compression: str = "none") -> int:
        """Per-device collective bytes of one round, scaled by the
        compression scheme's encoded:raw payload ratio (every formula is
        linear in ``|g|·b``)."""
        raw = self.bytes_fn(num_params, m, dtype_bytes, nbins)
        if compression != "none":
            from repro_torch.rounds import compression as comp_mod

            raw = raw * comp_mod.get_compression(compression).ratio(
                num_params, dtype_bytes)
        return int(raw)


_STRATEGIES: Dict[str, StrategySpec] = {}


def register_strategy(spec: StrategySpec) -> StrategySpec:
    if spec.name in _STRATEGIES:
        raise ValueError(f"strategy {spec.name!r} already registered")
    _STRATEGIES[spec.name] = spec
    return spec


def get_strategy_spec(name: str) -> StrategySpec:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered: "
            f"{', '.join(registered_strategies())}") from None


def registered_strategies() -> Tuple[str, ...]:
    """Registered strategy names, registration order."""
    return tuple(_STRATEGIES)


def _hier_split(m: int) -> Tuple[int, int]:
    """Balanced (pods, workers-per-pod) factorization used by the
    hierarchical byte model."""
    inner = max(1, int(math.isqrt(m)))
    while m % inner:
        inner -= 1
    return m // inner, inner


register_strategy(StrategySpec(
    "gather", exact=True, max_access=attack_base.OMNISCIENT,
    bytes_formula="m·|g|",
    bytes_fn=lambda d, m, b, nbins: m * d * b,
    summary="paper-faithful: all-gather every per-worker gradient",
))
register_strategy(StrategySpec(
    "bucketed", exact=True, max_access=attack_base.OMNISCIENT,
    bytes_formula="≈2·|g|",
    bytes_fn=lambda d, m, b, nbins: 2 * d * b,
    summary="all_to_all buckets + all_gather — robustness at all-reduce cost",
))
register_strategy(StrategySpec(
    "rs", exact=True, max_access=attack_base.OMNISCIENT,
    bytes_formula="≈|g|",
    bytes_fn=lambda d, m, b, nbins: d * b,
    summary="robust reduce-scatter (result stays sharded; fsdp backward)",
))
register_strategy(StrategySpec(
    "hierarchical", exact=False, max_access=attack_base.OMNISCIENT,
    bytes_formula="(m_pod + m_dcn)·|g|",
    bytes_fn=lambda d, m, b, nbins: sum(_hier_split(m)) * d * b,
    summary="median-of-medians across pods (different estimator — DESIGN.md)",
))
register_strategy(StrategySpec(
    "chunked", exact=False, max_access=attack_base.STATS,
    bytes_formula="≈(2 + 2·nbins)·|g| — independent of m",
    bytes_fn=lambda d, m, b, nbins: (2 + 2 * nbins) * d * b,
    summary="histogram sketch via psum; no per-worker rows ever gathered",
))
register_strategy(StrategySpec(
    "psum", exact=True, max_access=attack_base.STATS,
    bytes_formula="≈2·|g|",
    bytes_fn=lambda d, m, b, nbins: 2 * d * b,
    summary="plain all-reduce mean — NO robustness; the throughput baseline",
))


def validate_attack_strategy(attack, strategy: str) -> None:
    """Build-time check: the attack's gradient-access level must be one
    the strategy reproduces.

    ``attack`` is an AttackConfig, a registered attack name, an Attack
    spec, or None.  Raises ValueError for e.g. an omniscient attack
    (mimic, max_damage_tm) on the chunked or psum strategy, which never
    materialize the per-worker rows the attack reads.
    """
    spec = get_strategy_spec(strategy)
    atk = resolve_attack(attack)[0]
    if atk is None:
        return
    if attack_base.access_rank(atk.access) > attack_base.access_rank(spec.max_access):
        able = [s for s in registered_strategies()
                if attack_base.access_rank(get_strategy_spec(s).max_access)
                >= attack_base.access_rank(atk.access)]
        raise ValueError(
            f"attack {atk.name!r} needs {atk.access!r} gradient access, but "
            f"strategy {strategy!r} only reproduces up to {spec.max_access!r} "
            f"(it never materializes what the attack reads); use one of {able}")


def refuse_leaf_global(attack, strategy: str, model: int) -> None:
    """Under a model axis (``model`` > 1) the bucketed strategies cannot run
    a leaf-global attack (``Attack.leaf_global``: mimic's argmax over a
    bucket's sum): a rank's buckets are slices of its own ravel, not of the
    global ravel the reference's GSPMD buckets cut, so the attack would see
    other rows.  Raises ValueError; the gather strategies complete the
    attack's sums over the model shards instead."""
    if model == 1 or strategy not in ("bucketed", "rs"):
        return
    atk, alpha, _ = resolve_attack(attack)
    if atk is not None and atk.leaf_global and (alpha is None or alpha > 0):
        raise ValueError(
            f"attack {atk.name!r} reads whole buckets, which strategy {strategy!r} cuts from "
            f"each rank's own ravel at model axis {model}; use the gather or hierarchical "
            "strategy (their attack sums are psummed over the model axis)")


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


@dataclasses.dataclass
class CommBudget:
    """Accumulated bytes communicated over one run of one (strategy,
    model) pair: ``charge()`` each aggregation round, read
    ``total_bytes`` at the end; ``report()`` is the JSON-ready record."""

    strategy: str
    num_params: int
    m: int
    dtype_bytes: int = 4
    nbins: int = 256
    compression: str = "none"  # rounds.compression scheme scaling the bytes
    rounds: int = 0

    def spec(self) -> StrategySpec:
        return get_strategy_spec(self.strategy)

    @property
    def bytes_per_round(self) -> int:
        return self.spec().bytes_per_round(
            self.num_params, self.m, self.dtype_bytes, self.nbins,
            compression=self.compression)

    def charge(self, rounds: int = 1) -> None:
        if rounds < 0:
            raise ValueError(f"cannot charge {rounds} rounds")
        self.rounds += rounds

    @property
    def total_bytes(self) -> int:
        return self.bytes_per_round * self.rounds

    def report(self) -> dict:
        return {
            "strategy": self.strategy,
            "num_params": self.num_params,
            "m": self.m,
            "dtype_bytes": self.dtype_bytes,
            "nbins": self.nbins,
            "compression": self.compression,
            "rounds": self.rounds,
            "bytes_per_round": self.bytes_per_round,
            "total_bytes": self.total_bytes,
            "bytes_formula": self.spec().bytes_formula,
        }
