"""Composable payload compression under the CommBudget.

A :class:`CompressionSpec` registry declares, per scheme:

- ``encode_fn`` / ``decode_fn`` — the wire codec.  Workers transmit
  ``encode(x)``; every consumer (the robust aggregator AND the attack
  engine) sees only ``decode(encode(x))``, the decoded transmitted values,
  so attacks act after decoding and Byzantine payloads are unconstrained
  vectors (a stronger adversary than one held to the codec's image);
- a bytes model (``bytes_fn`` and the formula ``bytes_formula``), priced
  into ``comm.StrategySpec.bytes_per_round`` / ``CommBudget`` as the
  encoded : raw payload ratio;
- a declared rate penalty (multiplies the core/theory.py bounds) and
  breakdown scale (multiplies the usable Byzantine-fraction ceiling);
- whether the scheme carries error feedback: top-k keeps a per-worker
  residual ``e <- (x + e) - decode(encode(x + e))`` that lives in the
  caller's round state.

Registered schemes: ``none`` (identity; every integration returns before
any codec code runs, so the uncompressed paths stay bit-exact), ``int8``
(stochastic rounding with a per-256-chunk scale, unbiased), ``topk`` (the
quarter of largest magnitude, with error feedback) and ``count_sketch``
(a sign-hash count sketch of width |g|/2, one public linear map per round
shared by every worker and rotated across rounds).

Every codec works on float32 vectors along the last dimension, so one call
encodes a whole stack of rows ``(m, d)``.  Randomness: the int8 dither
``u`` and a round's count-sketch hash and signs are drawn from a
``torch.Generator`` the caller passes (on the payload's device), or are
passed in as ``draw=`` — the federated path draws the dither per client id
from :func:`repro_torch.rng.uniform`, so its trajectories do not depend on
the streaming chunk size, and the parity tests inject the reference's
draws.  Without a generator or a draw the count sketch takes the fixed
public hash (:func:`_sketch_hash`, numpy ``RandomState(1729)``, the
reference's exactly).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import ravel, tree_leaves, tree_map, tree_unflatten_like

# fixed seed of the shared count-sketch hash: one PUBLIC map (server and
# all workers agree on it), not per-call randomness
_SKETCH_SEED = 1729
#: coordinates the card's sketch accumulates at a time (2^26: ~1 GiB of
#: sort buffers)
_SKETCH_BLOCK = 1 << 26
#: base seed of the round programs' codec draws (the reference's PRNGKey(11))
DRAW_SEED = 11


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """One compression scheme's codec, cost and theory contract.

    ``encode_fn(x, knob, generator, draw)`` maps float32 rows ``(..., d)``
    to the wire dict (``draw`` is the scheme's randomness, drawn from
    ``generator`` when None); ``decode_fn(enc, d, knob)`` inverts it,
    lossily.  ``bytes_fn(num_params, dtype_bytes)`` prices the encoded
    payload of one d-vector; ``rate_penalty`` multiplies the theory's
    bounds and ``breakdown_scale`` the usable Byzantine-fraction ceiling.
    ``error_feedback`` schemes need a residual threaded by the caller
    (:func:`init_residual`); ``randomized`` schemes draw per worker;
    ``shared_key`` schemes draw one map per round, shared by every worker.
    """

    name: str
    bytes_formula: str
    bytes_fn: Callable[[int, int], int]
    encode_fn: Callable
    decode_fn: Callable
    rate_penalty: float = 1.0
    breakdown_scale: float = 1.0
    error_feedback: bool = False
    randomized: bool = False
    shared_key: bool = False
    unbiased: bool = False  # E[decode(encode(x))] == x
    knob: float = 0.0  # chunk size (int8) / kept fraction (topk, sketch)
    summary: str = ""

    def payload_bytes(self, num_params: int, dtype_bytes: int = 4) -> int:
        return int(self.bytes_fn(num_params, dtype_bytes))

    def ratio(self, num_params: int, dtype_bytes: int = 4) -> float:
        """Encoded : raw payload size, the factor every strategy's byte
        formula scales by."""
        return self.payload_bytes(num_params, dtype_bytes) / float(
            num_params * dtype_bytes)


_COMPRESSIONS: Dict[str, CompressionSpec] = {}


def register_compression(spec: CompressionSpec) -> CompressionSpec:
    if spec.name in _COMPRESSIONS:
        raise ValueError(f"compression {spec.name!r} already registered")
    _COMPRESSIONS[spec.name] = spec
    return spec


def get_compression(name: str) -> CompressionSpec:
    try:
        return _COMPRESSIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown compression {name!r}; registered: "
            f"{', '.join(registered_compressions())}") from None


def registered_compressions() -> Tuple[str, ...]:
    """Registered scheme names, registration order."""
    return tuple(_COMPRESSIONS)


# ------------------------------------------------------------------ codecs


def _true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    # a full-size divisor: CUDA divides by a host scalar via its reciprocal
    return x / torch.full_like(x, s)


def int8_draw_shape(d: int, knob: float = 256) -> Tuple[int, int]:
    """(chunks, chunk) of one d-vector's int8 dither."""
    chunk = int(knob)
    return -(-d // chunk), chunk


def _int8_encode(x: torch.Tensor, knob: float, generator=None, draw=None):
    """Per-chunk-scaled stochastic int8: q = floor(x/scale + u), u ~ U[0,1),
    unbiased for any real value.  The scale, max|x| over each ``knob``-sized
    chunk / 127, keeps the grid local, so one huge coordinate does not wash
    out the rest of the vector.  ``draw`` is ``u``, shaped
    ``x.shape[:-1] + int8_draw_shape(d)``."""
    if draw is None and generator is None:
        raise ValueError("int8 stochastic quantization needs a generator or a draw")
    d = x.shape[-1]
    nc, chunk = int8_draw_shape(d, knob)
    xf = x.to(torch.float32)
    xp = torch.nn.functional.pad(xf, (0, nc * chunk - d)).reshape(
        x.shape[:-1] + (nc, chunk))
    scale = _true_div(xp.abs().amax(dim=-1, keepdim=True), 127.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    u = draw if draw is not None else torch.rand(
        xp.shape, generator=generator, device=x.device)
    q = torch.clamp(torch.floor(xp / scale + u.to(xp.device)), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _int8_decode(enc, d: int, knob: float) -> torch.Tensor:
    out = enc["q"].to(torch.float32) * enc["scale"]
    return out.reshape(out.shape[:-2] + (-1,))[..., :d]


def _topk_k(d: int, knob: float) -> int:
    return max(1, min(d, int(round(knob * d))))


def _topk_encode(x: torch.Tensor, knob: float, generator=None, draw=None):
    k = _topk_k(x.shape[-1], knob)
    idx = torch.topk(x.abs(), k, dim=-1).indices
    return {"idx": idx, "val": torch.gather(x, -1, idx)}


def _topk_decode(enc, d: int, knob: float) -> torch.Tensor:
    val = enc["val"]
    out = torch.zeros(val.shape[:-1] + (d,), dtype=val.dtype, device=val.device)
    return out.scatter(-1, enc["idx"], val)


@functools.lru_cache(maxsize=None)
def _sketch_hash(d: int, w: int):
    """The fixed (bucket, sign) hash of the width-w count sketch over d
    coordinates: numpy host constants, the reference's bits exactly."""
    rng = np.random.RandomState(_SKETCH_SEED)
    h = rng.randint(0, w, size=d).astype(np.int32)
    s = (rng.randint(0, 2, size=d) * 2 - 1).astype(np.float32)
    return h, s


def _sketch_w(d: int, knob: float) -> int:
    return max(1, min(d, int(round(knob * d))))


def sketch_draw(d: int, generator: torch.Generator, knob: float = 0.5, *, device="cpu"):
    """One round's public count-sketch map (bucket, sign) over d
    coordinates, drawn from ``generator``."""
    w = _sketch_w(d, knob)
    h = torch.randint(0, w, (d,), generator=generator, device=device)
    s = torch.randint(0, 2, (d,), generator=generator, device=device).to(torch.float32) * 2 - 1
    return h, s


def _sketch_encode(x: torch.Tensor, knob: float, generator=None, draw=None):
    """Width-w sign-hash count sketch: decode(encode(x)) = AᵀA·x for the
    w×d sketch matrix A.  A FIXED hash would pin null(A) forever and stall
    GD, so the integrations rotate it every round (one map per round,
    shared by every worker: ``draw`` = (h, s), or drawn from
    ``generator``); without either, the fixed public hash.  ``h``/``s``
    ride the encoded dict for the decoder but are public, not payload."""
    d = x.shape[-1]
    w = _sketch_w(d, knob)
    if draw is not None:
        h, s = draw
    elif generator is not None:
        h, s = sketch_draw(d, generator, knob, device=x.device)
    else:
        h, s = (torch.from_numpy(a) for a in _sketch_hash(d, w))
    h = h.to(device=x.device, dtype=torch.int64)
    s = s.to(device=x.device, dtype=torch.float32)
    sketch = torch.zeros(x.shape[:-1] + (w,), dtype=torch.float32, device=x.device)
    sketch_accumulate(sketch, h, s * x)
    return {"sketch": sketch, "h": h, "s": s}


def sketch_accumulate(sketch: torch.Tensor, h: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``sketch[..., h[i]] += vals[..., i]`` in place, every bucket's terms
    added one at a time in the order of i: the same bits on every call and
    on both devices.  On the CPU ``index_add_`` (a serial loop; the CPU's
    ``index_put_`` accumulates in parallel, in no fixed order, past a few
    thousand coordinates); on the card ``index_put_``'s accumulation
    (:func:`_put_accumulate`; the card's ``index_add_`` adds with atomics,
    in no fixed order)."""
    if not sketch.is_cuda:
        return sketch.index_add_(sketch.dim() - 1, h, vals)
    return _put_accumulate(sketch, h, vals)


def _put_accumulate(sketch: torch.Tensor, h: torch.Tensor, vals: torch.Tensor,
                    block: int = None) -> torch.Tensor:
    """:func:`sketch_accumulate` through ``index_put_(accumulate=True)``,
    which sorts the indices stably and adds each bucket's terms in their
    order, ``block`` (default ``_SKETCH_BLOCK``) coordinates at a time, as
    its sort's buffers grow with the indices."""
    block = block or _SKETCH_BLOCK
    d, w = vals.shape[-1], sketch.shape[-1]
    rows, flat = sketch.view(-1, w).T, vals.reshape(-1, d)
    for a in range(0, d, block):
        rows.index_put_((h[a:a + block],), flat[:, a:a + block].T, accumulate=True)
    return sketch


def _sketch_decode(enc, d: int, knob: float) -> torch.Tensor:
    return enc["s"] * enc["sketch"][..., enc["h"]]


register_compression(CompressionSpec(
    "none",
    bytes_formula="|g|·b",
    bytes_fn=lambda d, b: d * b,
    encode_fn=lambda x, knob, generator=None, draw=None: x,
    decode_fn=lambda enc, d, knob: enc,
    rate_penalty=1.0, unbiased=True,
    summary="identity — full-precision payloads (the uncompressed pin)",
))
register_compression(CompressionSpec(
    "int8",
    bytes_formula="|g| + ⌈|g|/256⌉·b (int8 + per-chunk scale)",
    bytes_fn=lambda d, b: d + (-(-d // 256)) * b,
    encode_fn=_int8_encode, decode_fn=_int8_decode,
    rate_penalty=1.5, randomized=True, unbiased=True, knob=256,
    summary="stochastic byte quantization, per-256-chunk scale (unbiased)",
))
register_compression(CompressionSpec(
    "topk",
    bytes_formula="⌈|g|/4⌉·(b + 4) (value + int32 index)",
    bytes_fn=lambda d, b: _topk_k(d, 0.25) * (b + 4),
    encode_fn=_topk_encode, decode_fn=_topk_decode,
    rate_penalty=2.0, error_feedback=True, knob=0.25,
    summary="top-k by magnitude (k = |g|/4) with error-feedback residual",
))
register_compression(CompressionSpec(
    "count_sketch",
    bytes_formula="⌈|g|/2⌉·b (sign-hash sketch, width |g|/2)",
    bytes_fn=lambda d, b: _sketch_w(d, 0.5) * b,
    encode_fn=_sketch_encode, decode_fn=_sketch_decode,
    rate_penalty=4.0, breakdown_scale=0.5, shared_key=True, unbiased=True,
    knob=0.5,
    summary="per-round-rotated sign-hash count sketch; composes with the "
            "histogram sketch (linear decode — DESIGN.md §Compression)",
))


# -------------------------------------------------------------- application


def _apply_flat(spec: CompressionSpec, x: torch.Tensor, res, generator=None, draw=None):
    """Payload rows ``x`` (..., d) through the codec, with error feedback
    when the spec carries it: transmit decode(encode(x + e)), keep
    e' = (x + e) - transmitted.  Returns (transmitted, residual)."""
    d = x.shape[-1]
    if spec.error_feedback:
        tot = x + res
        out = spec.decode_fn(spec.encode_fn(tot, spec.knob, generator, draw), d, spec.knob)
        return out, tot - out
    out = spec.decode_fn(spec.encode_fn(x, spec.knob, generator, draw), d, spec.knob)
    return out, res


def roundtrip(name: str, x: torch.Tensor, *, generator=None, draw=None) -> torch.Tensor:
    """decode(encode(x)) for one flat vector — the values the wire
    delivers.  ``none`` returns ``x`` itself (no codec code runs)."""
    spec = get_compression(name)
    if spec.name == "none":
        return x
    return spec.decode_fn(spec.encode_fn(x, spec.knob, generator, draw), x.shape[-1],
                          spec.knob)


def init_residual(name: str, like):
    """Initial error-feedback state for a payload shaped ``like`` (a tree
    or a tensor): float32 zeros for error-feedback schemes, ``()`` for the
    others (so round-state carries keep a structure fixed at build time)."""
    spec = get_compression(name)
    if not spec.error_feedback:
        return ()
    return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                    like)


def compress_rows(name: str, rows: torch.Tensor, *, generator=None, draw=None,
                  residual=None):
    """Compress stacked per-worker payloads ``rows`` (m, ...) row by row.

    Returns ``(decoded_rows, new_residual)`` with shapes preserved.  A
    randomized codec takes ``draw`` (int8: ``(m,) + int8_draw_shape(d)``)
    or draws it from ``generator``, each row its own; a shared-key codec
    uses one map for every row (``draw`` or one draw from ``generator``;
    the fixed public hash without either).  Error-feedback schemes need
    ``residual`` (rows' shape; :func:`init_residual`).
    """
    spec = get_compression(name)
    if spec.name == "none":
        return rows, residual
    if spec.error_feedback and residual is None:
        raise ValueError(
            f"compression {spec.name!r} carries an error-feedback residual; "
            "pass residual=init_residual(name, rows) and thread the returned "
            "state through the round loop")
    if spec.randomized and generator is None and draw is None:
        raise ValueError(
            f"compression {spec.name!r} is randomized; pass generator= or draw=")
    m = rows.shape[0]
    flat = rows.reshape(m, -1)
    res = residual.reshape(m, -1) if spec.error_feedback else None
    out, new_res = _apply_flat(spec, flat, res, generator, draw)
    if spec.error_feedback:
        return out.reshape(rows.shape), new_res.reshape(residual.shape)
    return out.reshape(rows.shape), residual


def compress_tree_rows(name: str, tree, *, generator=None, residual=None):
    """:func:`compress_rows` over every leaf of a stacked (m, ...) tree
    (the round engines' delta trees); the leaves draw one after the other
    from ``generator``, so no two share a draw.  Returns
    ``(tree_hat, new_residual_tree)``."""
    spec = get_compression(name)
    if spec.name == "none":
        return tree, residual
    leaves = tree_leaves(tree)
    res_leaves = (tree_leaves(residual) if spec.error_feedback
                  else [None] * len(leaves))
    out, new_res = [], []
    for leaf, res in zip(leaves, res_leaves):
        o, r = compress_rows(name, leaf, generator=generator, residual=res)
        out.append(o)
        new_res.append(r)
    tree_hat = tree_unflatten_like(tree, out)
    if spec.error_feedback:
        return tree_hat, tree_unflatten_like(residual, new_res)
    return tree_hat, residual


def compress_tree(name: str, tree, *, generator=None, draw=None, residual=None):
    """Compress ONE worker's whole payload tree as a single flat message:
    ravel, codec, unravel.  ``residual`` is the flat (D,) error-feedback
    state.  Returns ``(tree_hat, new_residual)``."""
    spec = get_compression(name)
    if spec.name == "none":
        return tree, residual
    if spec.randomized and generator is None and draw is None:
        raise ValueError(f"compression {spec.name!r} is randomized; pass generator= or draw=")
    if spec.error_feedback and residual is None:
        raise ValueError(
            f"compression {spec.name!r} carries an error-feedback residual; "
            "thread it through the round state (init_residual)")
    flat, unravel = ravel(tree)
    out, new_res = _apply_flat(spec, flat.to(torch.float32), residual, generator, draw)
    return unravel(out.to(flat.dtype)), new_res


def validate_compression_context(name: str, *, stateful: bool,
                                 where: str) -> CompressionSpec:
    """Build-time check for the stateless integration points: an
    error-feedback scheme run WITHOUT its residual would measure plain
    sparsification while reporting error feedback, so it is rejected
    where no round state exists."""
    spec = get_compression(name)
    if spec.error_feedback and not stateful:
        raise ValueError(
            f"compression {spec.name!r} carries a per-worker error-feedback "
            f"residual, which {where} does not thread; use "
            "rounds.local_update.local_update_gd or fed.rounds.run_rounds — "
            "they carry the residual in their round state")
    return spec


def breakdown_alpha(name: str, alpha_max: float) -> float:
    """The usable Byzantine-fraction ceiling after compression: the
    aggregator's ceiling times the scheme's breakdown scale."""
    return get_compression(name).breakdown_scale * alpha_max
