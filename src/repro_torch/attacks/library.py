"""The registered attack library (the reference's formulas in torch).

Gradient-space formulas are written against :class:`AttackContext`;
the deterministic ones are bitwise the reference's on the same
statistics.  Randomized payloads draw from ``ctx.generator``.
``strength`` always scales damage monotonically.
"""
from __future__ import annotations

import math

import torch

from repro_torch.attacks.base import (
    DATA,
    FEEDBACK,
    LOCAL,
    OMNISCIENT,
    STATS,
    Attack,
    AttackContext,
)
from repro_torch.attacks.registry import alias, register

_VAR_EPS = 1e-12  # epsilon under the sqrt of the honest variance


def _std(ctx: AttackContext) -> torch.Tensor:
    return torch.sqrt(ctx.honest_var + _VAR_EPS)


# ------------------------------------------------------------------- stats


def _sign_flip(ctx: AttackContext) -> torch.Tensor:
    return -ctx.strength * ctx.honest_mean


def _large_value(ctx: AttackContext) -> torch.Tensor:
    return torch.full_like(ctx.own, ctx.strength)


def _alie(ctx: AttackContext) -> torch.Tensor:
    # "A Little Is Enough" (Baruch et al. 2019) with an explicit z_max:
    # shift every coordinate strength standard deviations below the mean.
    return ctx.honest_mean - ctx.strength * _std(ctx)


def _alie_fitted(ctx: AttackContext) -> torch.Tensor:
    # Variance-fitted ALIE: z_max = Phi^-1((m - q - s)/(m - q)) with
    # s = floor(m/2) + 1 - q supporters needed to capture the median,
    # computed in f32 as the reference does.
    m = ctx.m
    q = torch.ceil(torch.as_tensor(ctx.alpha * m, dtype=torch.float32)).clamp(max=m - 1)
    s = math.floor(m / 2.0) + 1.0 - q
    phi = (m - q - s) / (m - q).clamp(min=1.0)
    z = torch.special.ndtri(phi.clamp(1e-4, 1.0 - 1e-4))
    return ctx.honest_mean - ctx.strength * z * _std(ctx)


def _mean_shift(ctx: AttackContext) -> torch.Tensor:
    return ctx.honest_mean + ctx.strength * _std(ctx)


def _ipm(ctx: AttackContext) -> torch.Tensor:
    # Inner-product manipulation (Xie et al. 2020): -eps * mean.
    return -ctx.strength * ctx.honest_mean


# --------------------------------------------------------------- omniscient


def _mimic(ctx: AttackContext) -> torch.Tensor:
    # Mimic/clone (Karimireddy et al. 2022): all colluders replay the most
    # deviant HONEST row; strength interpolates mean -> cloned row.
    m = ctx.rows.shape[0]
    if ctx.row_sum is not None:  # a model shard of the leaf: its sum psummed
        d2 = ctx.row_sum((ctx.rows - ctx.honest_mean) ** 2)
    else:
        d2 = ((ctx.rows - ctx.honest_mean).reshape(m, -1) ** 2).sum(dim=1)
    d2 = torch.where(ctx.mask, torch.full_like(d2, -math.inf), d2)
    picked = ctx.rows[torch.argmax(d2)]
    return ctx.honest_mean + ctx.strength * (picked - ctx.honest_mean)


def _max_damage_tm(ctx: AttackContext) -> torch.Tensor:
    # All Byzantine mass AT the honest extreme that opposes descent (the
    # worst case for Definition 2); strength interpolates mean -> extreme.
    maskb = ctx.mask.reshape((ctx.rows.shape[0],) + (1,) * (ctx.rows.dim() - 1))
    lo = torch.where(maskb, torch.full_like(ctx.rows, math.inf), ctx.rows).amin(dim=0)
    hi = torch.where(maskb, torch.full_like(ctx.rows, -math.inf), ctx.rows).amax(dim=0)
    target = torch.where(ctx.honest_mean > 0, lo, hi)
    return ctx.honest_mean + ctx.strength * (target - ctx.honest_mean)


# -------------------------------------------------------------------- local


def _local_sign_flip(ctx: AttackContext) -> torch.Tensor:
    # each Byzantine worker flips ITS OWN gradient (no collusion)
    return -ctx.strength * ctx.own


def _gauss(ctx: AttackContext) -> torch.Tensor:
    # pure-noise gradients, drawn over the whole leaf (a model shard cuts
    # its part of the draw)
    shape = ctx.own.shape if ctx.whole is None else ctx.whole[0]
    noise = torch.randn(shape, generator=ctx.generator, dtype=torch.float32,
                        device=ctx.own.device)
    if ctx.whole is not None:
        noise = ctx.whole[1](noise)
    return ctx.strength * noise.to(ctx.own.dtype)


def _zero(ctx: AttackContext) -> torch.Tensor:
    # free-rider / dropped update; strength has no effect by design
    return torch.zeros_like(ctx.own)


def _stale(ctx: AttackContext) -> torch.Tensor:
    # replay a PAST broadcast aggregate at the worker's staleness depth
    # (clipped to the kept history), scaled by strength
    hist = ctx.agg_history
    depth = torch.as_tensor(ctx.staleness, device=hist.device).clamp(1, hist.shape[0])
    stale = hist.index_select(0, (depth - 1).reshape(1).long())[0]
    return ctx.strength * stale.expand(ctx.own.shape).to(ctx.own.dtype)


# ----------------------------------------------------------------- feedback


def _feedback_flip(scores: torch.Tensor, generator, strength) -> torch.Tensor:
    # praise what the model got wrong; strength interpolates honest -> flip
    return scores - 2.0 * min(strength, 1.0) * scores


def _feedback_alie(scores: torch.Tensor, generator, strength) -> torch.Tensor:
    # every Byzantine user reports mean - s*std of its own honest scores
    mu = scores.mean()
    sd = torch.sqrt(scores.var(unbiased=False).clamp(min=_VAR_EPS))
    return (mu - strength * sd).expand(scores.shape)


# --------------------------------------------------------------------- data


def _flip_labels(y: torch.Tensor, generator, num_classes: int) -> torch.Tensor:
    return (num_classes - 1) - y


def _random_labels(y: torch.Tensor, generator, num_classes: int) -> torch.Tensor:
    return torch.randint(0, num_classes, y.shape, generator=generator,
                         dtype=y.dtype, device=y.device)


# ------------------------------------------------------------- registration

register(Attack("sign_flip", STATS, _sign_flip, strength=100.0,
                summary="-s * honest mean (reverse attack)"))
register(Attack("large_value", LOCAL, _large_value, strength=100.0,
                summary="constant s in every coordinate"))
register(Attack("alie", STATS, _alie, strength=1.0, needs_variance=True,
                summary="mean - s*std (ALIE, explicit z_max = s)"))
register(Attack("alie_fitted", STATS, _alie_fitted, strength=1.0, needs_variance=True,
                summary="mean - s*z(m, alpha)*std (variance-fitted ALIE)"))
register(Attack("mean_shift", STATS, _mean_shift, strength=1.0, needs_variance=True,
                summary="mean + s*std omniscient shift"))
register(Attack("ipm", STATS, _ipm, strength=1.0,
                summary="-s * mean (inner-product manipulation)"))
alias("inner_product", "ipm")
register(Attack("mimic", OMNISCIENT, _mimic, strength=1.0, leaf_global=True,
                summary="clone the most deviant honest row"))
register(Attack("max_damage_tm", OMNISCIENT, _max_damage_tm, strength=1.0,
                summary="honest extreme opposing descent (anti-trimmed-mean)"))
register(Attack("local_sign_flip", LOCAL, _local_sign_flip, strength=1.0,
                reads_own=True,
                summary="-s * own gradient (no collusion)"))
register(Attack("gauss", LOCAL, _gauss, strength=1.0, randomized=True,
                summary="s * N(0, I) noise gradient"))
register(Attack("zero", LOCAL, _zero, strength=1.0,
                summary="zero gradient (free-rider)"))
register(Attack("stale", LOCAL, _stale, strength=1.0, adaptive=True,
                summary="s * stale broadcast aggregate, replayed at true depth"))
register(Attack("stale_exploit", LOCAL, _stale, strength=1.0, adaptive=True,
                arrival="last",
                summary="stale replay timed to lag into the buffer tail"))
register(Attack("stale_exploit_greedy", LOCAL, _stale, strength=1.0, adaptive=True,
                arrival="greedy",
                summary="stale replay with greedily-timed arrivals"))
register(Attack("label_flip", DATA, corrupt_labels=_flip_labels,
                summary="y -> (C-1) - y on Byzantine shards"))
register(Attack("random_label", DATA, corrupt_labels=_random_labels,
                randomized=True, summary="iid uniform labels on Byzantine shards"))
register(Attack("feedback_flip", FEEDBACK, corrupt_feedback=_feedback_flip,
                summary="score -> -score on Byzantine users' feedback"))
register(Attack("feedback_alie", FEEDBACK, corrupt_feedback=_feedback_alie,
                strength=1.5,
                summary="mean - s*std of own scores (ALIE in score space)"))
