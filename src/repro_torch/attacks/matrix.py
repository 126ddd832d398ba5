"""Robustness scenario matrix + CI gate.

Runs the (attack x aggregator x alpha x m) grid on the paper's
Proposition-1 linear-regression task and checks every cell's final error
``||w_T - w*||`` against the statistical-rate bounds of
:mod:`repro_torch.core.theory`.

All cells of one program — one (aggregator, m) of the sync and feedback
grids, one (aggregator, codec, m) of the compressed grid, one
(aggregator, m, buffer size) of the async grid — step together: the
per-cell iterates are one (C, d) tensor, the per-cell gradients one
``einsum`` over (C, m, n), the honest statistics one call per alpha
(cells with one alpha share a Byzantine mask), each attack's payload one
call over that attack's cells, and a coordinate-wise aggregator (median,
trimmed mean, mean) one call a step over the (m, C, d) view of the rows,
which the median and trimmed mean flatten to (m, C*d) — on the card one
B1/B2 launch for all cells, bitwise the per-cell results because every
column is independent.  Any other
aggregator a caller names (``krum``, ``geometric_median``) runs cell by
cell.  ``num_traces`` counts the programs run.

Gate semantics (the robustness CI job):

- ``median``        gated for every alpha < 1/2 against
                    K_MEDIAN * Delta of eq. (3) (theory.delta_median);
- ``trimmed_mean``  gated when ceil(alpha*m) <= floor(beta*m) (inside its
                    breakdown point) against K_TRIMMED * Delta' of eq. (5);
- ``mean``          gated ONLY at alpha = 0 (the classical rate); under
                    attack its cells are reported, not gated;
- cells beyond an aggregator's breakdown point are reported ungated.

The **compressed** grid (:func:`evaluate_compressed`) passes every
worker's rows through a :mod:`repro_torch.rounds.compression` codec
before the attack (attacks act on the DECODED values), gated against the
codec-scaled bounds.  The **async** grid (:func:`evaluate_async`) packs
``stale_exploit`` reports into a k-of-m buffer starved by honest
dropout, gated against the effective-m bounds; all-Byzantine buffers are
recorded infeasible.  The **feedback** grid (:func:`evaluate_feedback`)
weights the regression targets by per-sample feedback scores, which
Byzantine shards poison through :func:`engine.corrupt_feedback` before
computing honest gradients; gated at the score-weighted noise scale.

K_* absorb the paper's universal constants (the reference's values).

CLI::

    python -m repro_torch.attacks.matrix [--smoke] [--json PATH] [--seed S] [--device cuda|cpu]

exits non-zero iff any gated cell violates its bound; it runs on the card
unless ``--device cpu``.  The data comes from torch generators seeded
with (seed, m), so errors differ from the reference's (JAX's threefry
draws); the cells, bounds and flags are the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.attacks import base, engine
from repro_torch.core import aggregators, theory
from repro_torch.device import resolve
from repro_torch.rounds import compression as comp_lib

# (attack name, strength) cells of the default grid — every registered
# gradient/data attack, at a strength that separates robust from broken
# aggregators.
DEFAULT_ATTACKS: Tuple[Tuple[str, float], ...] = (
    ("sign_flip", 10.0),
    ("large_value", 50.0),
    ("alie", 1.5),
    ("alie_fitted", 1.0),
    ("mean_shift", 10.0),
    ("ipm", 0.5),
    ("mimic", 1.0),
    ("max_damage_tm", 1.0),
    ("local_sign_flip", 5.0),
    ("gauss", 10.0),
    ("zero", 1.0),
    ("stale", 1.0),
    ("stale_exploit", 1.0),
    ("label_flip", 1.0),
    ("random_label", 1.0),
)

# Calibration of the theory formulas' hidden universal constants and
# finite-T slack (the reference's): a healthy grid passes with >= ~3x
# margin, a broken aggregator fails by orders of magnitude.  Delta' of
# eq. (5) carries a v*d/eps prefactor that is loose at these d, hence the
# sub-1 trimmed-mean constant.
K_MEDIAN = 1.0
K_TRIMMED = 0.25
K_MEAN = 3.0

#: aggregators whose cells aggregate in one call over (m, C*d)
COORDINATE_WISE = ("median", "trimmed_mean", "mean")


@dataclasses.dataclass(frozen=True)
class MatrixConfig:
    aggregators: Tuple[str, ...] = ("median", "trimmed_mean", "mean")
    attacks: Tuple[Tuple[str, float], ...] = DEFAULT_ATTACKS
    alphas: Tuple[float, ...] = (0.05, 0.15, 0.25)
    ms: Tuple[int, ...] = (16, 32)
    beta: float = 0.3  # trimmed-mean trim fraction (>= max alpha)
    n: int = 256  # samples per worker
    d: int = 32
    sigma: float = 0.5
    iters: int = 60
    lr: float = 0.5
    seed: int = 0


SMOKE = MatrixConfig(ms=(16,), n=64, d=16, iters=40)


def cell_bound(agg: str, alpha: float, beta: float, n: int, m: int, d: int,
               sigma: float) -> Optional[float]:
    """Theory bound for one cell; None = ungated (breakdown regime or no
    guarantee exists for this aggregator/alpha)."""
    if agg == "median":
        if alpha >= 0.5:
            return None
        return K_MEDIAN * theory.delta_median(alpha, n, m, d, V=sigma, S=3.0)
    if agg == "trimmed_mean":
        if math.ceil(alpha * m) > math.floor(beta * m):
            return None  # beyond the breakdown point beta
        return K_TRIMMED * theory.delta_trimmed(beta, n, m, d, v=sigma)
    if agg == "mean":
        if alpha > 0:
            return None  # no Byzantine guarantee — reported, not gated
        return K_MEAN * theory.lower_bound(0.0, n, m, d, sigma)
    return None  # beyond-paper baselines (krum, geometric_median): report only


# ------------------------------------------------------------------ data


def _make_data(cfg, m: int, device):
    """(x, y, y_flip, y_rand, w_star) of m workers: Rademacher features
    (m, n, d), targets y = x w* + sigma * noise, the data attacks'
    flipped (-y) and pure-noise targets; drawn on the CPU from a generator
    seeded with (seed, m), then moved to ``device``."""
    gen = rng.generator(cfg.seed, m)
    x = torch.randint(0, 2, (m, cfg.n, cfg.d), generator=gen).to(torch.float32) * 2 - 1
    w_star = torch.randn(cfg.d, generator=gen) / math.sqrt(cfg.d)
    y = torch.einsum("mnd,d->mn", x, w_star)
    y = y + cfg.sigma * torch.randn(y.shape, generator=gen)
    y_rand = cfg.sigma * torch.randn(y.shape, generator=gen)
    return tuple(t.to(device) for t in (x, y, -y, y_rand, w_star))


def _make_feedback_data(cfg, m: int, device):
    """(x, y, w_star, s) of m workers: the Proposition-1 task plus
    per-sample feedback scores s = base + spread * tanh(N(0, 1)), drawn on
    the CPU from a generator seeded with (seed, m)."""
    gen = rng.generator(cfg.seed, m)
    x = torch.randint(0, 2, (m, cfg.n, cfg.d), generator=gen).to(torch.float32) * 2 - 1
    w_star = torch.randn(cfg.d, generator=gen) / math.sqrt(cfg.d)
    y = torch.einsum("mnd,d->mn", x, w_star)
    y = y + cfg.sigma * torch.randn(y.shape, generator=gen)
    s = cfg.score_base + cfg.score_spread * torch.tanh(torch.randn(y.shape, generator=gen))
    return tuple(t.to(device) for t in (x, y, w_star, s))


# --------------------------------------------------------- batched cells


def _gradients(x: torch.Tensor, W: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(C, m, d) local gradients of ½‖ys − x w_c‖²/n for C cells' iterates
    W (C, d) on the shards x (m, n, d); ys is (m, n) or per cell (C, m, n)."""
    r = torch.einsum("mnd,cd->cmn", x, W) - ys
    g = torch.einsum("mnd,cmn->cmd", x, r)
    return g / torch.full_like(g, x.shape[1])


def aggregate_cells(agg_name: str, beta: float, rows: torch.Tensor) -> torch.Tensor:
    """Every cell's aggregate of its rows (C, m, d) -> (C, d).  A
    coordinate-wise aggregator takes all cells in one call over the (m, C,
    d) view (the median and trimmed mean flatten it to (m, C*d): one
    kernel launch; the mean reduces the view's first axis, which torch
    sums in the per-cell order); any other runs cell by cell."""
    agg = aggregators.get_aggregator(agg_name, beta)
    if agg_name in COORDINATE_WISE:
        return agg(rows.transpose(0, 1))
    return torch.stack([agg(rows[c]) for c in range(rows.shape[0])])


def _final_err(W: torch.Tensor, target: torch.Tensor) -> list:
    err = torch.linalg.vector_norm(W - target, dim=1)
    return torch.nan_to_num(err, nan=math.inf, posinf=math.inf).tolist()


def _cells(attacks, alphas):
    """(names, attack indices, alphas, strengths): one clean cell (index
    -1, alpha 0), then attack x alpha, the reference's order."""
    names, idxs, alphas_, strengths = ["none"], [-1], [0.0], [1.0]
    for i, (name, s) in enumerate(attacks):
        for a in alphas:
            names.append(name)
            idxs.append(i)
            alphas_.append(a)
            strengths.append(s)
    return names, idxs, alphas_, strengths


class _AttackedRows:
    """Byzantine-row replacement for a program's cells, batched: the
    honest statistics one call per alpha, each attack's payload one call
    over its cells (omniscient attacks read per-cell masks and rows, so
    theirs run cell by cell)."""

    def __init__(self, attacks, idxs, alphas, strengths, m: int, device):
        self.specs = [engine.as_attack(name) for name, _ in attacks]
        self.m = m
        self.masks = torch.stack([torch.arange(m, device=device) < engine.num_byzantine(a, m)
                                  for a in alphas])  # (C, m)
        self.alpha = torch.tensor(alphas, dtype=torch.float32, device=device)
        self.strengths = strengths
        by_alpha, by_attack = {}, {}
        for c, (i, a) in enumerate(zip(idxs, alphas)):
            if i >= 0:
                by_alpha.setdefault(a, []).append(c)
                by_attack.setdefault(i, []).append(c)
        # (cells as a list, as an index tensor on the device)
        self.by_alpha = [(cs, torch.tensor(cs, device=device)) for cs in by_alpha.values()]
        self.by_attack = [(i, cs, torch.tensor(cs, device=device))
                          for i, cs in by_attack.items()]

    def __call__(self, g, prev, r: int, data_grads, generator_for) -> torch.Tensor:
        """Rows (C, m, d) of step r: each cell's gradients ``g`` with its
        Byzantine rows replaced.  ``prev`` (C, d) is the previous step's
        aggregate; ``data_grads(attack, idx)`` a data attack's gradients;
        ``generator_for(r)`` a randomized attack's generator."""
        m = self.m
        mean, var = torch.zeros_like(g[:, 0]), torch.zeros_like(g[:, 0])
        for cs, idx in self.by_alpha:
            mu, v = engine.honest_statistics(g[idx].transpose(0, 1), self.masks[cs[0]])
            mean[idx], var[idx] = mu, v
        rows = g.clone()
        for i, cs, idx in self.by_attack:
            atk, strength = self.specs[i], self.strengths[cs[0]]
            gen = generator_for(r) if atk.randomized and atk.access != base.DATA else None
            if atk.access == base.DATA:
                bad = data_grads(atk, idx)
            elif atk.access == base.OMNISCIENT:
                bad = torch.stack([atk.payload(engine.build_context(
                    atk, m=m, alpha=self.alpha[c], strength=strength, mask=self.masks[c],
                    rows=g[c], own=g[c], honest_mean=mean[c], honest_var=var[c],
                    generator=gen, prev_agg=prev[c], rnd=r)).expand(g.shape[1:])
                    for c in cs])
            else:
                own = g[idx].transpose(0, 1)  # (m, Ci, d)
                ctx = engine.build_context(
                    atk, m=m, alpha=self.alpha[idx][:, None], strength=strength, rows=own,
                    own=own, honest_mean=mean[idx], honest_var=var[idx], generator=gen,
                    prev_agg=prev[idx], rnd=r)
                bad = atk.payload(ctx).expand(own.shape).transpose(0, 1)
            rows[idx] = torch.where(self.masks[idx][:, :, None], bad.to(g.dtype), g[idx])
        return rows


def _records(names, alphas, strengths, errs, bound_of, aggregator: str, m: int,
             **extra) -> list:
    """The reference's cell records of one program."""
    cells = []
    for name, a, s, err in zip(names, alphas, strengths, errs):
        bound = bound_of(a)
        cells.append({"attack": name, "aggregator": aggregator, **extra, "alpha": a,
                      "m": m, "strength": s, "err": err, "bound": bound,
                      "gated": bound is not None, "ok": bound is None or err <= bound})
    return cells


def evaluate(cfg: MatrixConfig = MatrixConfig(), verbose: bool = False,
             device="cuda") -> dict:
    """Run the grid; returns {"task", "config", "num_traces", "cells",
    "violations"} (the reference's layout)."""
    dev = resolve(device)
    counter = 0
    cells = []
    names, idxs, alphas, strengths = _cells(cfg.attacks, cfg.alphas)
    for m in cfg.ms:
        x, y, y_flip, y_rand, w_star = _make_data(cfg, m, dev)
        attacked = _AttackedRows(cfg.attacks, idxs, alphas, strengths, m, dev)
        for agg_name in cfg.aggregators:
            counter += 1
            W = torch.zeros((len(names), cfg.d), dtype=torch.float32, device=dev)
            prev = torch.zeros_like(W)
            for r in range(cfg.iters):
                g = _gradients(x, W, y)
                rows = attacked(
                    g, prev, r,
                    lambda atk, idx: _gradients(
                        x, W[idx], y_flip if atk.name == "label_flip" else y_rand),
                    lambda r_: rng.generator(cfg.seed + 1, m, r_, device=dev))
                prev = aggregate_cells(agg_name, cfg.beta, rows)
                W = W - cfg.lr * prev
            cells += _records(
                names, alphas, strengths, _final_err(W, w_star),
                lambda a: cell_bound(agg_name, a, cfg.beta, cfg.n, m, cfg.d, cfg.sigma),
                agg_name, m)
    violations = [c for c in cells if not c["ok"]]
    out = {"task": "linreg-prop1", "config": dataclasses.asdict(cfg),
           "num_traces": counter, "cells": cells, "violations": violations}
    if verbose:
        for c in cells:
            gate = ("VIOLATION" if not c["ok"] else
                    f"<= {c['bound']:.3f}" if c["gated"] else "ungated")
            print(f"  {c['aggregator']:13s} {c['attack']:15s} a={c['alpha']:.2f} "
                  f"m={c['m']:3d} err={min(c['err'], 1e9):10.4f}  [{gate}]")
        print(f"  {len(cells)} cells, {counter} programs, {len(violations)} violations")
    return out


# ------------------------------------------------------ compressed cells
#
# Every worker's transmitted gradient passes through a codec BEFORE the
# attack, so Byzantine rows replace the DECODED values and the adversary
# reads its statistics from the decoded honest rows.  Every cell of a step
# shares the step's codec draws (the int8 dither, the count-sketch map),
# drawn from a generator seeded with (DRAW_SEED, step), as the reference's
# cells share one key a step.


@dataclasses.dataclass(frozen=True)
class CompressedMatrixConfig:
    aggregators: Tuple[str, ...] = ("median", "trimmed_mean")
    compressions: Tuple[str, ...] = ("none", "int8", "topk", "count_sketch")
    attacks: Tuple[Tuple[str, float], ...] = (("sign_flip", 10.0),
                                              ("alie", 1.5))
    alphas: Tuple[float, ...] = (0.05, 0.25)
    ms: Tuple[int, ...] = (16,)
    beta: float = 0.3
    n: int = 256
    d: int = 32
    sigma: float = 0.5
    iters: int = 60
    lr: float = 0.5
    seed: int = 0


COMPRESSED_SMOKE = CompressedMatrixConfig(n=64, d=16, iters=40)


def cell_bound_compressed(agg: str, comp: str, alpha: float, beta: float,
                          n: int, m: int, d: int,
                          sigma: float) -> Optional[float]:
    """Codec-scaled theory bound for one compressed cell; None = ungated
    (at or beyond the codec-scaled breakdown ceiling)."""
    spec = comp_lib.get_compression(comp)
    if agg == "median":
        if alpha >= theory.compressed_breakdown(0.5, spec.breakdown_scale):
            return None
        return K_MEDIAN * theory.delta_median_compressed(
            alpha, n, m, d, V=sigma, S=3.0, rate_penalty=spec.rate_penalty)
    if agg == "trimmed_mean":
        if math.ceil(alpha * m) > math.floor(beta * m):
            return None  # beyond the trim budget, codec or not
        if alpha >= theory.compressed_breakdown(beta, spec.breakdown_scale):
            return None
        return K_TRIMMED * theory.delta_trimmed_compressed(
            beta, n, m, d, v=sigma, rate_penalty=spec.rate_penalty)
    return None


def _codec_draw(spec, cells: int, m: int, d: int, r: int, device):
    """Step r's codec randomness, the same for every cell: the int8 dither
    tiled over the cells' rows, or the count sketch's map."""
    gen = rng.generator(comp_lib.DRAW_SEED, r)
    if spec.randomized:
        u = torch.rand((m,) + comp_lib.int8_draw_shape(d, spec.knob), generator=gen)
        return u.to(device).repeat(cells, 1, 1)
    if spec.shared_key:
        return comp_lib.sketch_draw(d, gen, spec.knob)
    return None


def evaluate_compressed(cfg: CompressedMatrixConfig = CompressedMatrixConfig(),
                        verbose: bool = False, device="cuda") -> dict:
    """Run the compressed grid; same payload shape as evaluate()."""
    dev = resolve(device)
    counter = 0
    cells = []
    names, idxs, alphas, strengths = _cells(cfg.attacks, cfg.alphas)
    C = len(names)
    for m in cfg.ms:
        x, y, _, _, w_star = _make_data(
            MatrixConfig(n=cfg.n, d=cfg.d, sigma=cfg.sigma, seed=cfg.seed), m, dev)
        attacked = _AttackedRows(cfg.attacks, idxs, alphas, strengths, m, dev)
        for agg_name in cfg.aggregators:
            for comp in cfg.compressions:
                counter += 1
                spec = comp_lib.get_compression(comp)
                W = torch.zeros((C, cfg.d), dtype=torch.float32, device=dev)
                prev = torch.zeros_like(W)
                res = (torch.zeros((C * m, cfg.d), dtype=torch.float32, device=dev)
                       if spec.error_feedback else None)
                for r in range(cfg.iters):
                    g, res = comp_lib.compress_rows(
                        comp, _gradients(x, W, y).reshape(C * m, cfg.d),
                        draw=_codec_draw(spec, C, m, cfg.d, r, dev), residual=res)
                    rows = attacked(g.reshape(C, m, cfg.d), prev, r, None,
                                    lambda r_: rng.generator(cfg.seed + 1, m, r_, device=dev))
                    prev = aggregate_cells(agg_name, cfg.beta, rows)
                    W = W - cfg.lr * prev
                cells += _records(
                    names, alphas, strengths, _final_err(W, w_star),
                    lambda a: cell_bound_compressed(agg_name, comp, a, cfg.beta, cfg.n, m,
                                                    cfg.d, cfg.sigma),
                    agg_name, m, compression=comp)
    violations = [c for c in cells if not c["ok"]]
    out = {"task": "linreg-prop1-compressed", "config": dataclasses.asdict(cfg),
           "num_traces": counter, "cells": cells, "violations": violations}
    if verbose:
        for c in cells:
            gate = ("VIOLATION" if not c["ok"] else
                    f"<= {c['bound']:.3f}" if c["gated"] else
                    "ungated (codec breakdown)")
            print(f"  comp {c['aggregator']:13s} {c['compression']:12s} "
                  f"{c['attack']:10s} a={c['alpha']:.2f} m={c['m']:3d} "
                  f"err={min(c['err'], 1e9):10.4f}  [{gate}]")
        print(f"  {len(cells)} compressed cells, {counter} programs, "
              f"{len(violations)} violations")
    return out


# ------------------------------------------------------- async buffer cells
#
# The stale_exploit adversary packs the buffer window (its q reports always
# make the k-of-m buffer, replaying the aggregate from ``replay_depth``
# rounds back) while honest dropout shrinks the honest side — the
# worst-case composition theory.effective_buffer models.  A cell's
# composition is static: q_buf stale-replay rows + h_buf fresh honest rows
# (workers q..q+h_buf-1).  Cells with one buffer size k_actual step as one
# program; the step carries (w, aggregate history) per cell.


@dataclasses.dataclass(frozen=True)
class AsyncMatrixConfig:
    aggregators: Tuple[str, ...] = ("median", "trimmed_mean")
    alphas: Tuple[float, ...] = (0.05, 0.25)
    k_fracs: Tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)
    dropouts: Tuple[float, ...] = (0.0, 0.25)
    ms: Tuple[int, ...] = (16, 32)
    beta: float = 0.3
    n: int = 256
    d: int = 32
    sigma: float = 0.5
    iters: int = 60
    lr: float = 0.5
    seed: int = 0
    attack: str = "stale_exploit"
    strength: float = 1.0
    replay_depth: int = 2  # rounds back the exploiters' replay reaches
    history: int = 3  # broadcast-aggregate history depth carried


ASYNC_SMOKE = AsyncMatrixConfig(
    ms=(16,), k_fracs=(0.5, 1.0), n=64, d=16, iters=40)


def cell_bound_async(agg: str, alpha: float, beta: float, n: int, m: int,
                     k: int, dropout: float, d: int,
                     sigma: float) -> Optional[float]:
    """Effective-m theory bound for one buffered cell; None = the
    concentrated alpha_eff is beyond the aggregator's breakdown point."""
    k_act, alpha_eff = theory.effective_buffer(alpha, m, k, dropout)
    if agg == "median":
        if alpha_eff >= 0.5:
            return None
        return K_MEDIAN * theory.delta_median_async(
            alpha, n, m, k, d, V=sigma, S=3.0, dropout=dropout)
    if agg == "trimmed_mean":
        if math.ceil(alpha_eff * k_act) > math.floor(beta * k_act):
            return None  # buffer-concentrated breakdown
        return K_TRIMMED * theory.delta_trimmed_async(
            beta, alpha, n, m, k, d, v=sigma, dropout=dropout)
    return None


def async_cells(cfg: AsyncMatrixConfig, m: int, agg_name: str) -> list:
    """(cell record, composition (q, q_buf, h_buf)) of each cell of one (m,
    aggregator), the reference's order; a cell is feasible when h_buf >= 1."""
    out = []
    for alpha in cfg.alphas:
        q = engine.num_byzantine(alpha, m)
        for k_frac in cfg.k_fracs:
            k = max(1, int(round(k_frac * m)))
            for dropout in cfg.dropouts:
                k_act, alpha_eff = theory.effective_buffer(alpha, m, k, dropout)
                q_buf = min(k, q)
                out.append(({
                    "attack": cfg.attack, "aggregator": agg_name,
                    "alpha": alpha, "m": m, "k": k, "k_frac": k_frac,
                    "dropout": dropout, "k_actual": k_act,
                    "alpha_eff": alpha_eff, "m_eff": max(1, k_act - q_buf),
                    "strength": cfg.strength}, (q, q_buf, k_act - q_buf)))
    return out


def _run_async_program(agg_name: str, cfg: AsyncMatrixConfig, m: int, data, comps,
                       device) -> list:
    """Final errors of cells with one buffer size and compositions
    ``comps`` [(q, q_buf, h_buf)], stepped together."""
    x, y, _, _, w_star = data
    atk = engine.as_attack(cfg.attack)
    C = len(comps)
    W = torch.zeros((C, cfg.d), dtype=torch.float32, device=device)
    hist = torch.zeros((cfg.history, C, cfg.d), dtype=torch.float32, device=device)
    for r in range(cfg.iters):
        g = _gradients(x, W, y)
        rows = []
        for c, (q, q_buf, h_buf) in enumerate(comps):
            honest = g[c, q:q + h_buf]
            if q_buf > 0:
                k_act = q_buf + h_buf
                ctx = engine.build_context(
                    atk, m=k_act, alpha=q_buf / k_act, strength=cfg.strength,
                    own=torch.zeros((q_buf, cfg.d), device=device),
                    agg_history=hist[:, c], staleness=cfg.replay_depth, rnd=r)
                honest = torch.cat([atk.payload(ctx).expand(q_buf, cfg.d), honest])
            rows.append(honest)
        g_agg = aggregate_cells(agg_name, cfg.beta, torch.stack(rows))
        W = W - cfg.lr * g_agg
        hist = torch.cat([g_agg[None], hist[:-1]], dim=0)
    return _final_err(W, w_star)


def evaluate_async(cfg: AsyncMatrixConfig = AsyncMatrixConfig(),
                   verbose: bool = False, device="cuda") -> dict:
    """Run the buffered-round grid; same payload shape as evaluate()."""
    dev = resolve(device)
    counter = 0
    cells = []
    for m in cfg.ms:
        data = _make_data(
            MatrixConfig(n=cfg.n, d=cfg.d, sigma=cfg.sigma, seed=cfg.seed), m, dev)
        for agg_name in cfg.aggregators:
            recs = async_cells(cfg, m, agg_name)
            programs = {}  # k_actual -> feasible cells
            for rec, comp in recs:
                if comp[2] >= 1:
                    programs.setdefault(rec["k_actual"], []).append((rec, comp))
                else:  # all-Byzantine buffer: no estimate
                    rec.update(feasible=False, err=None, bound=None, gated=False, ok=True)
            for group in programs.values():
                counter += 1
                errs = _run_async_program(agg_name, cfg, m, data, [c for _, c in group], dev)
                for (rec, _), err in zip(group, errs):
                    bound = cell_bound_async(agg_name, rec["alpha"], cfg.beta, cfg.n, m,
                                             rec["k"], rec["dropout"], cfg.d, cfg.sigma)
                    rec.update(feasible=True, err=err, bound=bound, gated=bound is not None,
                               ok=bound is None or err <= bound)
            cells += [rec for rec, _ in recs]
    violations = [c for c in cells if not c["ok"]]
    out = {"task": "linreg-prop1-buffered", "config": dataclasses.asdict(cfg),
           "num_traces": counter, "cells": cells, "violations": violations}
    if verbose:
        for c in cells:
            if not c["feasible"]:
                gate = "infeasible (all-Byzantine buffer)"
            elif not c["ok"]:
                gate = "VIOLATION"
            elif c["gated"]:
                gate = f"<= {c['bound']:.3f}"
            else:
                gate = "ungated (alpha_eff breakdown)"
            e = "   --   " if c["err"] is None else f"{min(c['err'], 1e9):8.4f}"
            print(f"  async {c['aggregator']:13s} a={c['alpha']:.2f} "
                  f"m={c['m']:3d} k={c['k']:3d} drop={c['dropout']:.2f} "
                  f"a_eff={c['alpha_eff']:.2f} err={e}  [{gate}]")
        print(f"  {len(cells)} async cells, {counter} programs, "
              f"{len(violations)} violations")
    return out


# ---------------------------------------------------------- feedback cells
#
# Each worker holds per-sample feedback scores s in (0.7, 0.9) that weight
# its regression targets, so the feedback-weighted optimum is E[s] * w*
# and a cell's error is ||w_T - E[s] * w*||.  Byzantine shards run their
# score vectors through engine.corrupt_feedback once per cell and then
# compute HONEST gradients from the poisoned scores — corruption never
# touches the wire (the FEEDBACK access class).  Gated like the sync grid
# at the score-weighted noise scale ``feedback_sigma``; the mean is gated
# only at alpha = 0 (under attack its stationary point is biased).


@dataclasses.dataclass(frozen=True)
class FeedbackMatrixConfig:
    aggregators: Tuple[str, ...] = ("median", "trimmed_mean", "mean")
    attacks: Tuple[Tuple[str, float], ...] = (("feedback_flip", 1.0),
                                              ("feedback_alie", 1.5))
    alphas: Tuple[float, ...] = (0.1, 0.25, 0.45)
    ms: Tuple[int, ...] = (16, 32)
    beta: float = 0.3
    n: int = 256
    d: int = 32
    sigma: float = 0.5
    score_base: float = 0.8  # E[s]: the feedback-weighted optimum scale
    score_spread: float = 0.1  # s = base + spread * tanh(xi)
    iters: int = 60
    lr: float = 0.5
    seed: int = 0


FEEDBACK_SMOKE = FeedbackMatrixConfig(ms=(16,), n=64, d=16, iters=40)

_VAR_TANH = 0.3942  # Var[tanh(xi)], xi ~ N(0, 1)


def feedback_sigma(cfg: FeedbackMatrixConfig) -> float:
    """Effective per-sample noise scale of the score-weighted residual
    s*y - x'(E[s] w*): Var[(s - E[s]) x'w*] + E[s^2] sigma^2 with
    E||w*||^2 = 1 by construction."""
    var_s = cfg.score_spread ** 2 * _VAR_TANH
    e_s2 = cfg.score_base ** 2 + var_s
    return math.sqrt(var_s + e_s2 * cfg.sigma ** 2)


def cell_bound_feedback(agg: str, alpha: float, cfg: FeedbackMatrixConfig,
                        m: int) -> Optional[float]:
    """Theory bound for one feedback cell at the score-weighted noise
    scale; None = ungated (breakdown regime / attacked mean)."""
    sig = feedback_sigma(cfg)
    if agg == "median":
        # gate on the REALIZED Byzantine count: alpha = 0.45 at m = 16
        # rounds up to 8/16 — exactly at the 1/2 breakdown
        if 2 * math.ceil(alpha * m) >= m:
            return None
        return K_MEDIAN * theory.delta_median(
            alpha, cfg.n, m, cfg.d, V=sig, S=3.0)
    if agg == "trimmed_mean":
        if math.ceil(alpha * m) > math.floor(cfg.beta * m):
            return None  # beyond the breakdown point beta
        return K_TRIMMED * theory.delta_trimmed(
            cfg.beta, cfg.n, m, cfg.d, v=sig)
    if agg == "mean":
        if alpha > 0:
            return None  # biased stationary point — reported, not gated
        return K_MEAN * theory.lower_bound(0.0, cfg.n, m, cfg.d, sig)
    return None


def _poisoned_scores(cfg: FeedbackMatrixConfig, s_honest: torch.Tensor, idxs, alphas,
                     strengths) -> torch.Tensor:
    """(C, m, n) scores each cell's workers report: the Byzantine workers'
    rows through corrupt_feedback worker by worker (a randomized attack
    draws from a generator seeded with (seed + 1, cell, worker)), the
    others' honest."""
    m = s_honest.shape[0]
    specs = [engine.as_attack(name) for name, _ in cfg.attacks]
    out = []
    for c, (i, a, strength) in enumerate(zip(idxs, alphas, strengths)):
        q = engine.num_byzantine(a, m)
        rows = list(s_honest)
        for w in range(q):
            gen = (rng.generator(cfg.seed + 1, c, w, device=s_honest.device)
                   if specs[i].randomized else None)
            rows[w] = engine.corrupt_feedback(specs[i], s_honest[w], gen, strength)
        out.append(torch.stack(rows))
    return torch.stack(out)


def evaluate_feedback(cfg: FeedbackMatrixConfig = FeedbackMatrixConfig(),
                      verbose: bool = False, device="cuda") -> dict:
    """Run the poisoned-feedback grid; same payload shape as evaluate()."""
    dev = resolve(device)
    counter = 0
    cells = []
    names, idxs, alphas, strengths = _cells(cfg.attacks, cfg.alphas)
    for m in cfg.ms:
        x, y, w_star, s_honest = _make_feedback_data(cfg, m, dev)
        targets = _poisoned_scores(cfg, s_honest, idxs, alphas, strengths) * y
        for agg_name in cfg.aggregators:
            counter += 1
            W = torch.zeros((len(names), cfg.d), dtype=torch.float32, device=dev)
            for _ in range(cfg.iters):
                W = W - cfg.lr * aggregate_cells(agg_name, cfg.beta,
                                                 _gradients(x, W, targets))
            cells += _records(
                names, alphas, strengths, _final_err(W, cfg.score_base * w_star),
                lambda a: cell_bound_feedback(agg_name, a, cfg, m), agg_name, m)
    violations = [c for c in cells if not c["ok"]]
    out = {"task": "linreg-prop1-feedback", "config": dataclasses.asdict(cfg),
           "num_traces": counter, "cells": cells, "violations": violations}
    if verbose:
        for c in cells:
            gate = ("VIOLATION" if not c["ok"] else
                    f"<= {c['bound']:.3f}" if c["gated"] else
                    "ungated" + (" (biased mean)"
                                 if c["aggregator"] == "mean" else ""))
            print(f"  fb   {c['aggregator']:13s} {c['attack']:15s} "
                  f"a={c['alpha']:.2f} m={c['m']:3d} "
                  f"err={min(c['err'], 1e9):10.4f}  [{gate}]")
        print(f"  {len(cells)} feedback cells, {counter} programs, "
              f"{len(violations)} violations")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.attacks.matrix",
        description="Robustness scenario matrix: attack x aggregator x alpha "
                    "x m grid, gated against core/theory.py bounds")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized grid (single m, smaller n/d/T)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable matrix to PATH")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    cfg = SMOKE if args.smoke else MatrixConfig()
    ccfg = COMPRESSED_SMOKE if args.smoke else CompressedMatrixConfig()
    acfg = ASYNC_SMOKE if args.smoke else AsyncMatrixConfig()
    fcfg = FEEDBACK_SMOKE if args.smoke else FeedbackMatrixConfig()
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
        ccfg = dataclasses.replace(ccfg, seed=args.seed)
        acfg = dataclasses.replace(acfg, seed=args.seed)
        fcfg = dataclasses.replace(fcfg, seed=args.seed)
    out = evaluate(cfg, verbose=True, device=args.device)
    out["compressed"] = evaluate_compressed(ccfg, verbose=True, device=args.device)
    out["async"] = evaluate_async(acfg, verbose=True, device=args.device)
    out["feedback"] = evaluate_feedback(fcfg, verbose=True, device=args.device)
    violations = (out["violations"] + out["compressed"]["violations"]
                  + out["async"]["violations"]
                  + out["feedback"]["violations"])
    if args.json is not None:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json} ({len(out['cells'])} sync + "
              f"{len(out['compressed']['cells'])} compressed + "
              f"{len(out['async']['cells'])} async + "
              f"{len(out['feedback']['cells'])} feedback cells)",
              file=sys.stderr)
    if violations:
        for c in violations:
            where = (f"k={c['k']} drop={c['dropout']}" if "k" in c
                     else f"m={c['m']}")
            if "compression" in c:
                where += f" comp={c['compression']}"
            print(f"GATE robustness: {c['aggregator']} x {c['attack']} "
                  f"alpha={c['alpha']} {where}: err {c['err']:.4f} > "
                  f"bound {c['bound']:.4f}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
