"""Staleness policies for buffered asynchronous rounds.

A buffered round (:mod:`repro_torch.fed.async_rounds`) aggregates the
first k of m arrivals; a client whose report was computed against the
round-(r-s) iterate lands in round r's buffer with staleness s >= 1.  A
staleness policy decides what the aggregator does with such rows BEFORE
the robust aggregation runs — the aggregator itself is unchanged, the
policy only reweights, widens the trim, or drops:

``none``       keep late deltas at full weight (FedBuffer's baseline);
``damped``     polynomial discount (1+s)^-p — the staleness damping of
               async SGD (Xie et al. 2019's s_a(t));
``trim_late``  don't reweight, instead widen the trimmed-mean fraction
               beta by the late fraction of the buffer, so every stale
               row could be trimmed as an outlier;
``drop``       hard-drop rows older than a staleness cap.

Every policy must be the identity at zero staleness (weight(0) == 1, no
drops, no extra trim): that invariance is what makes the k=m
zero-latency sync pin bit-for-bit exact.  Pure numpy on the host — a
copy of the reference's module, so the policies are bitwise its own on
the same staleness vectors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

# weight_fn(staleness_array, knob) -> per-row multiplier in [0, 1];
# staleness is a host-side int array
WeightFn = Callable[[np.ndarray, float], np.ndarray]


@dataclasses.dataclass(frozen=True)
class StalenessPolicySpec:
    """One staleness policy's contract.

    ``weight_fn(s, knob)`` maps integer staleness to a multiplicative
    down-weight (1.0 at s=0 for every policy).  ``extra_trim`` policies
    widen the trimmed-mean beta by the buffer's late fraction instead of
    reweighting; ``drops_late`` policies remove rows with s > cap.  The
    ``knob``/``cap`` defaults are what the CLI and AsyncConfig use when
    the user doesn't override them.
    """

    name: str
    weight_fn: WeightFn
    extra_trim: bool = False  # widen beta by the late fraction
    drops_late: bool = False  # drop rows with staleness > cap
    knob: float = 0.5  # default policy knob (exponent for damped)
    cap: int = 2  # default staleness cap (drop policy)
    summary: str = ""

    def weight(self, staleness, knob: float = None) -> np.ndarray:
        s = np.asarray(staleness, dtype=np.int64)
        k = self.knob if knob is None else knob
        w = np.asarray(self.weight_fn(s, k), dtype=np.float64)
        return np.clip(w, 0.0, 1.0)


_POLICIES: Dict[str, StalenessPolicySpec] = {}


def register_policy(spec: StalenessPolicySpec) -> StalenessPolicySpec:
    if spec.name in _POLICIES:
        raise ValueError(f"staleness policy {spec.name!r} already registered")
    _POLICIES[spec.name] = spec
    return spec


def get_policy(name: str) -> StalenessPolicySpec:
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown staleness policy {name!r}; registered: "
            f"{', '.join(registered_policies())}") from None


def registered_policies() -> Tuple[str, ...]:
    """Registered policy names, registration order."""
    return tuple(_POLICIES)


def apply_policy(name: str, staleness, *, knob: float = None,
                 cap: int = None, beta: float = 0.1):
    """Resolve a policy against a buffer's staleness vector.

    Returns ``(keep, weights, beta_eff)``: a bool keep-mask over the
    buffered rows, per-row multiplicative weights (aligned to the FULL
    staleness vector — index with ``keep`` before use), and the effective
    trimmed-mean fraction."""
    spec = get_policy(name)
    s = np.asarray(staleness, dtype=np.int64)
    cap = spec.cap if cap is None else cap
    keep = np.ones(s.shape, dtype=bool)
    if spec.drops_late:
        keep = s <= cap
        if not keep.any():  # never drop the whole buffer: keep freshest
            keep = s == s.min()
    weights = spec.weight(s, knob)
    beta_eff = beta
    if spec.extra_trim:
        late_frac = float(np.mean(s[keep] > 0)) if keep.any() else 0.0
        beta_eff = min(0.45, beta + late_frac)
    return keep, weights, beta_eff


# ------------------------------------------------------------- registration

register_policy(StalenessPolicySpec(
    "none", weight_fn=lambda s, k: np.ones(s.shape),
    summary="full weight for late deltas (FedBuffer baseline)",
))
register_policy(StalenessPolicySpec(
    "damped", weight_fn=lambda s, k: (1.0 + s) ** (-k), knob=0.5,
    summary="(1+s)^-p polynomial staleness discount (p = knob)",
))
register_policy(StalenessPolicySpec(
    "trim_late", weight_fn=lambda s, k: np.ones(s.shape), extra_trim=True,
    summary="widen trimmed-mean beta by the buffer's late fraction",
))
register_policy(StalenessPolicySpec(
    "drop", weight_fn=lambda s, k: np.ones(s.shape), drops_late=True, cap=2,
    summary="hard-drop rows with staleness > cap",
))
