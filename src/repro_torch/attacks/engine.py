"""Applying registered attacks to gradients — the two execution paths.

``apply_to_rows``      gathered-rows path: per-worker gradients stacked
                       ``(m, ...)`` are visible (robust_gd).  Supports
                       every access level.
``payload_from_stats`` statistics path: the caller supplies the honest
                       mean/variance; omniscient attacks need rows and
                       raise.

Both build the same :class:`AttackContext` from the same statistics.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.attacks.base import (
    DATA,
    FEEDBACK,
    LOCAL,
    OMNISCIENT,
    STATS,
    Attack,
    AttackContext,
    access_rank,
)
from repro_torch.attacks.registry import get_attack

AttackLike = Union[str, Attack]

#: Above this many rows the honest statistics sum in one reduction, not
#: row by row.  XLA's CPU reduction adds rows in order 0..m-1 only for
#: small m, so bitwise payload parity with the reference holds up to here
#: and is a tolerance above it; a federated chunk (hundreds of clients)
#: would otherwise pay one launch per row.
ROW_ORDER_MAX_M = 64


def as_attack(attack: AttackLike) -> Attack:
    return attack if isinstance(attack, Attack) else get_attack(attack)


def num_byzantine(alpha, m: int):
    """ceil(alpha*m), capped at m-1; 0 for alpha<=0.  A Python int for a
    Python number, an int tensor for a tensor alpha."""
    if isinstance(alpha, (int, float)):
        return min(m - 1, math.ceil(alpha * m)) if alpha > 0 else 0
    q = torch.ceil(alpha * m).clamp(max=m - 1)
    return torch.where(alpha > 0, q, torch.zeros_like(q)).to(torch.int32)


def byzantine_mask(alpha, m: int, *, device="cuda") -> torch.Tensor:
    """(m,) bool mask, workers 0..q-1 Byzantine (which workers is
    immaterial to permutation-invariant aggregators)."""
    q = num_byzantine(alpha, m)
    if isinstance(q, int):  # a host count: no copy to the device
        return torch.arange(m, device=device) < q
    return torch.arange(m, device=device) < torch.as_tensor(q, device=device)


def build_context(
    attack: Attack,
    *,
    m: int,
    alpha,
    strength=None,
    mask: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,
    own: Optional[torch.Tensor] = None,
    honest_mean: Optional[torch.Tensor] = None,
    honest_var: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    prev_agg: Optional[torch.Tensor] = None,
    agg_history: Optional[torch.Tensor] = None,
    staleness=None,
    rnd=None,
    row_sum=None,
    whole=None,
) -> AttackContext:
    """Assemble a context exposing ONLY what ``attack.access`` grants.

    ``prev_agg`` and ``agg_history`` are two views of the same public
    broadcast state (a depth-1 history is built from ``prev_agg``);
    ``staleness`` defaults to 1 when any history exists.  A randomized
    attack without a generator gets one seeded 0 on the data's device.
    """
    rank = access_rank(attack.access)
    if strength is None:
        strength = attack.strength
    if generator is None and attack.randomized:
        like = next(t for t in (own, rows, honest_mean) if t is not None)
        generator = torch.Generator(device=like.device).manual_seed(0)
    if agg_history is None and prev_agg is not None:
        agg_history = prev_agg.unsqueeze(0)
    elif prev_agg is None and agg_history is not None:
        prev_agg = agg_history[0]
    if staleness is None and agg_history is not None:
        staleness = 1
    return AttackContext(
        m=m,
        alpha=alpha,
        strength=strength,
        prev_agg=prev_agg,
        agg_history=agg_history,
        staleness=staleness,
        round=rnd,
        generator=generator,
        own=own if rank >= access_rank(LOCAL) else None,
        honest_mean=honest_mean if rank >= access_rank(STATS) else None,
        honest_var=honest_var if rank >= access_rank(STATS) else None,
        rows=rows if rank >= access_rank(OMNISCIENT) else None,
        mask=mask if rank >= access_rank(OMNISCIENT) else None,
        row_sum=row_sum,
        whole=whole,
    )


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    # rows added in order 0..m-1 up to ROW_ORDER_MAX_M; above it one
    # reduction, deterministic but in torch's order
    if x.shape[0] > ROW_ORDER_MAX_M:
        return x.sum(dim=0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def honest_statistics(stacked: torch.Tensor, mask: torch.Tensor):
    """Coordinate-wise mean and variance over the honest (unmasked) rows."""
    m = stacked.shape[0]
    maskb = mask.reshape((m,) + (1,) * (stacked.dim() - 1))
    n_honest = (m - mask.sum()).clamp(min=1)
    zero = torch.zeros((), dtype=stacked.dtype, device=stacked.device)
    mean = _row_sum(torch.where(maskb, zero, stacked)) / n_honest
    var = _row_sum(torch.where(maskb, zero, (stacked - mean) ** 2)) / n_honest
    return mean, var


def apply_to_rows(
    attack: AttackLike,
    stacked: torch.Tensor,
    mask: torch.Tensor,
    *,
    alpha=None,
    strength=None,
    generator: Optional[torch.Generator] = None,
    prev_agg: Optional[torch.Tensor] = None,
    agg_history: Optional[torch.Tensor] = None,
    staleness=None,
    rnd=None,
    row_sum=None,
    whole=None,
) -> torch.Tensor:
    """Replace Byzantine rows of ``stacked`` ``(m, ...)`` per ``mask``.

    Data and feedback attacks return ``stacked`` unchanged (they corrupt
    samples / feedback scores upstream of the gradient computation).
    ``row_sum`` completes a per-row sum over the leaf and ``whole`` (the
    whole rows' shape and the cut of ``stacked``'s part) sizes a
    randomized draw, where ``stacked`` holds a model shard of it
    (:class:`AttackContext`).
    """
    attack = as_attack(attack)
    if attack.access in (DATA, FEEDBACK):
        return stacked
    m = stacked.shape[0]
    if alpha is None:
        alpha = mask.sum() / m
    if prev_agg is None and agg_history is None and attack.adaptive:
        prev_agg = torch.zeros_like(stacked[0])
    mean, var = honest_statistics(stacked, mask)
    ctx = build_context(
        attack, m=m, alpha=alpha, strength=strength, mask=mask, rows=stacked,
        own=stacked, honest_mean=mean, honest_var=var, generator=generator,
        prev_agg=prev_agg, agg_history=agg_history, staleness=staleness, rnd=rnd,
        row_sum=row_sum, whole=whole,
    )
    bad = attack.payload(ctx)
    maskb = mask.reshape((m,) + (1,) * (stacked.dim() - 1))
    return torch.where(maskb, bad.to(stacked.dtype), stacked)


def payload_from_stats(
    attack: AttackLike,
    honest_mean: torch.Tensor,
    honest_var: Optional[torch.Tensor],
    *,
    m: int,
    alpha,
    strength=None,
    own: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    prev_agg: Optional[torch.Tensor] = None,
    agg_history: Optional[torch.Tensor] = None,
    staleness=None,
    rnd=None,
    whole=None,
) -> torch.Tensor:
    """The bad-row value for the no-rows (statistics) path.  ``own`` is
    this worker's local row (required by attacks that read it); ``whole``
    as :func:`apply_to_rows`'."""
    attack = as_attack(attack)
    if attack.access == OMNISCIENT:
        raise ValueError(
            f"attack {attack.name!r} is omniscient (needs per-worker rows) and "
            "cannot run on the statistics-only path")
    if attack.access in (DATA, FEEDBACK):
        raise ValueError(
            f"{attack.access} attack {attack.name!r} has no gradient payload")
    if own is None and attack.reads_own:
        raise ValueError(
            f"attack {attack.name!r} reads the worker's own gradient row; the "
            "caller must pass own= (honest_mean is only a shape donor)")
    ref = own if own is not None else honest_mean
    if prev_agg is None and agg_history is None and attack.adaptive:
        prev_agg = torch.zeros_like(ref)
    ctx = build_context(
        attack, m=m, alpha=alpha, strength=strength, own=ref,
        honest_mean=honest_mean, honest_var=honest_var, generator=generator,
        prev_agg=prev_agg, agg_history=agg_history, staleness=staleness, rnd=rnd,
        whole=whole,
    )
    return attack.payload(ctx)


def corrupt_labels(
    attack: AttackLike, y: torch.Tensor, generator: Optional[torch.Generator],
    num_classes: int,
) -> torch.Tensor:
    """Run a data attack's label corruption (identity for non-data attacks)."""
    attack = as_attack(attack)
    if attack.access != DATA:
        return y
    if generator is None:
        generator = torch.Generator(device=y.device).manual_seed(0)
    return attack.corrupt_labels(y, generator, num_classes)


def corrupt_feedback(
    attack: AttackLike,
    scores: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    strength=None,
) -> torch.Tensor:
    """Run a feedback attack's score corruption (identity otherwise).

    ``scores`` are per-sequence feedback values in [-1, 1]; the corrupted
    output is clipped back to that range.  A randomized feedback attack
    without a generator gets one seeded 0 on the scores' device.
    """
    attack = as_attack(attack)
    if attack.access != FEEDBACK:
        return scores
    if generator is None:
        generator = torch.Generator(device=scores.device).manual_seed(0)
    if strength is None:
        strength = attack.strength
    return torch.clamp(attack.corrupt_feedback(scores, generator, strength), -1.0, 1.0)
