"""The MoE combine as one dispatcher op with a hand-written backward.

The combine turns the experts' output rows ``ye`` (R, D) (the (E, B·cap)
buffer of :func:`repro_torch.models.moe._experts`, flattened) into each
token's float32 weighted sum of the rows its top-k pairs kept::

    y[t] = Σ_k keep[t, k] · weight[t, k] · float(ye[rows[t, k]])

for ``rows`` / ``keep`` / ``weight`` (..., K) and y (..., D).  Every kept
pair owns its row: routing gives each (expert, batch row, slot) at most
one pair.  So the backward writes each kept row's gradient once,
``d_ye[rows[t, k]] = (ye.dtype)(weight[t, k] · dy[t])``, with no
accumulation; rows no pair keeps read 0, and ``d_weight[t, k] = Σ_d
float(ye[rows[t, k], d]) · dy[t, d]`` in float32 (0 where not kept).  A pair
not kept is never read: its row index may be anything.

Replaces no TPU kernel: the JAX reference combines with a dense einsum.
As a PyTorch gather with the dropped pairs pointed at row 0, the backward
was an ``index_put_`` with accumulation over tens of thousands of
duplicate indices a call (``csrc/moe_combine.cu`` says more).

Device rule, as :mod:`robust_agg`'s: a CPU tensor takes the plain version
(:func:`combine_plain`, :func:`combine_backward_plain`, the forward the
gather-and-sum and the backward ``zeros`` plus an ``index_copy`` of the
kept rows); a CUDA tensor (``ye`` f32, bf16 or f16, D a multiple of 16
bytes of it, every row buffer 16-byte aligned) launches the kernels of
``csrc/moe_combine.cu`` or raises, nothing falls back; a meta or fake
tensor (the dry-run's stand-in) gets the outputs' shapes from the ops'
fake implementations and builds nothing.  The library is built and loaded
at the first CUDA call.  ``LAUNCHES`` counts the kernels' launches
(forward and backward).  The autograd function runs under ``torch.func``
(``grad``, ``vmap``) as the gather-and-sum did, on the plain route.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.device import takes_kernels
from repro_torch.kernels import build as _build

SOURCE = _build.CSRC / "moe_combine.cu"
#: the row types the kernels take
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: top-k pairs a token may have on the card (``kMaxK`` in the source)
MAX_K = 16

#: kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"forward": 0, "backward": 0}

_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call).  Raises when CUDA or
    nvcc is missing."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = _build.load(SOURCE, "mc_error_string", _build.BUILD_DIR)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.mc_combine.argtypes = [p, p, p, p, ll, i, ll, p, i, p]
            lib.mc_combine_backward.argtypes = [p, p, p, p, p, ll, i, ll, ll, p, p, i, p]
            lib.mc_combine.restype = lib.mc_combine_backward.restype = ctypes.c_int
            _LIB = lib
    return _LIB


# --------------------------------------------------------------------------
# the plain versions (the CPU route)
# --------------------------------------------------------------------------


def _kept(rows: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``rows`` with every pair not kept pointed at row 0."""
    return torch.where(keep, rows, torch.zeros_like(rows))


def combine_plain(ye: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """The combine as a gather and a sum over k, in float32 (a pair not kept
    weighs 0)."""
    w = torch.where(keep, weight, torch.zeros_like(weight))
    return torch.sum(ye[_kept(rows, keep)].float() * w[..., None], dim=-2)


def combine_backward_plain(dy: torch.Tensor, ye: torch.Tensor, rows: torch.Tensor,
                           keep: torch.Tensor, weight: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_ye, d_weight) of :func:`combine_plain` for the cotangent ``dy``:
    each kept row's ``w · dy`` rounded to ye's type and added to a zero (so
    a -0 reads +0, as an accumulating backward gives), copied once to its
    row (a pair not kept to one extra row, dropped); ``d_weight`` the f32
    sum over D, 0 where not kept."""
    n, d = ye.shape
    picked = ye[_kept(rows, keep)].float()
    d_weight = torch.sum(dy[..., None, :] * picked, dim=-1)
    d_weight = torch.where(keep, d_weight, torch.zeros_like(d_weight))
    grads = (dy[..., None, :] * weight[..., None]).to(ye.dtype) + 0
    dest = torch.where(keep, rows, torch.full_like(rows, n)).reshape(-1)
    d_ye = ye.new_zeros((n + 1, d)).index_copy(0, dest, grads.reshape(-1, d))[:n]
    return d_ye, d_weight


# --------------------------------------------------------------------------
# the dispatcher ops (their CUDA implementations launch the kernels)
# --------------------------------------------------------------------------


def _plan(ye: torch.Tensor, *f32: torch.Tensor) -> int:
    """The dtype code for the source's entry points, or raises where the
    kernels' 16-byte columns do not fit D or a pointer."""
    if ye.dtype not in DTYPES:
        raise TypeError("the combine kernels take float32, bfloat16 or float16 rows, "
                        f"got {ye.dtype}")
    if (ye.shape[-1] * ye.element_size()) % 16 or any(t.data_ptr() % 16 for t in (ye, *f32)):
        raise ValueError("the combine kernels take rows of a multiple of 16 bytes in 16-byte "
                         f"aligned buffers; got D {ye.shape[-1]} of {ye.dtype}")
    return DTYPES.index(ye.dtype)


def _combine_cuda(ye, rows, keep, weight) -> torch.Tensor:
    lib = load()
    k, d = rows.shape[-1], ye.shape[-1]
    y = ye.new_empty((*rows.shape[:-1], d), dtype=torch.float32)
    code = _plan(ye, y)
    err = _build.launch_on(ye.get_device(), lambda stream: lib.mc_combine(
        ye.data_ptr(), rows.data_ptr(), keep.data_ptr(), weight.data_ptr(), rows.numel() // k,
        k, d, y.data_ptr(), code, stream))
    _build.check_launch(lib, "moe_combine", err)
    LAUNCHES["forward"] += 1
    return y


def _combine_backward_cuda(dy, ye, rows, keep, weight) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = load()
    k, d = rows.shape[-1], ye.shape[-1]
    d_ye = torch.empty_like(ye)
    d_weight = torch.empty_like(weight)
    code = _plan(ye, dy, d_ye)
    err = _build.launch_on(ye.get_device(), lambda stream: lib.mc_combine_backward(
        dy.data_ptr(), ye.data_ptr(), rows.data_ptr(), keep.data_ptr(), weight.data_ptr(),
        rows.numel() // k, k, d, ye.shape[0], d_ye.data_ptr(), d_weight.data_ptr(), code, stream))
    _build.check_launch(lib, "moe_combine_backward", err)
    LAUNCHES["backward"] += 1
    return d_ye, d_weight


def _combine_fake(ye, rows, keep, weight) -> torch.Tensor:
    return ye.new_empty((*rows.shape[:-1], ye.shape[-1]), dtype=torch.float32)


def _combine_backward_fake(dy, ye, rows, keep, weight) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.empty_like(ye), torch.empty_like(weight)


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("moe_combine(Tensor ye, Tensor rows, Tensor keep, Tensor weight) -> Tensor")
_OPS.define("moe_combine_backward(Tensor dy, Tensor ye, Tensor rows, Tensor keep, "
            "Tensor weight) -> (Tensor, Tensor)")
_OPS.impl("moe_combine", _combine_cuda, "CUDA")
_OPS.impl("moe_combine_backward", _combine_backward_cuda, "CUDA")
torch.library.register_fake("repro_torch::moe_combine", _combine_fake, lib=_OPS)
torch.library.register_fake("repro_torch::moe_combine_backward", _combine_backward_fake,
                            lib=_OPS)
_COMBINE = torch.ops.repro_torch.moe_combine.default
_COMBINE_BACKWARD = torch.ops.repro_torch.moe_combine_backward.default


class _Combine(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(ye, rows, keep, weight):
        if takes_kernels(ye):
            return _COMBINE(ye, rows, keep, weight)
        return combine_plain(ye, rows, keep, weight)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        ye, rows, keep, weight = ctx.saved_tensors
        if takes_kernels(ye):
            d_ye, d_weight = _COMBINE_BACKWARD(dy.contiguous(), ye, rows, keep, weight)
        else:
            d_ye, d_weight = combine_backward_plain(dy, ye, rows, keep, weight)
        return d_ye, None, None, d_weight


def moe_combine(ye: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """Each token's f32 combine (..., D) of the rows ``ye`` (R, D) its kept
    pairs hold: ``rows`` (..., K) int64, ``keep`` (..., K) bool, ``weight``
    (..., K) float32 (module docstring).  Differentiable in ``ye`` and
    ``weight``."""
    k = rows.shape[-1]
    if ye.dim() != 2 or keep.shape != rows.shape or weight.shape != rows.shape:
        raise ValueError(f"expected ye (R, D) and rows, keep, weight of one shape (..., K); got "
                         f"{tuple(ye.shape)}, {tuple(rows.shape)}, {tuple(keep.shape)}, "
                         f"{tuple(weight.shape)}")
    if rows.dtype != torch.int64 or keep.dtype != torch.bool or weight.dtype != torch.float32:
        raise TypeError(f"expected int64 rows, bool keep and float32 weight; got {rows.dtype}, "
                        f"{keep.dtype}, {weight.dtype}")
    if ye.is_cuda and not 1 <= k <= MAX_K:
        raise ValueError(f"the combine kernels take 1 <= K <= {MAX_K} pairs a token, got {k}")
    return _Combine.apply(ye.contiguous(), rows.contiguous(), keep.contiguous(),
                          weight.contiguous())
