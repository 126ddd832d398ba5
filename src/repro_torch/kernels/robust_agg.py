"""Hand-written CUDA kernels for the coordinate-wise median / trimmed mean.

Replaces the reference's Pallas TPU kernels
(``src/repro/kernels/robust_agg.py``):

==============================  =====================================
wrapper here                    TPU kernel replaced
==============================  =====================================
:func:`median`                  ``median_pallas`` (``_median_kernel``)
:func:`trimmed_mean`            ``trimmed_mean_pallas``
:func:`fused_median_trimmed`    ``fused_median_trimmed_pallas``
==============================  =====================================

Source: ``csrc/robust_agg.cu`` (CUDA C++ for ``sm_90a``), built at first
use by :mod:`repro_torch.kernels.build` into ``build/repro_torch/`` at
the repository root and loaded with ctypes.  Bound: memory — m*n*s bytes
read and n*s written per output (s the element size); the source's
header says what the design does about it.

Device rule: a CPU tensor takes the plain version (the torch executor of
the same comparator program in :mod:`selection_network`); a CUDA tensor
launches the kernel or raises — nothing falls back.  ``LAUNCHES`` counts
kernel launches per wrapper, so a run can show that its aggregation went
through the kernels.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import selection_network as SN

SOURCE = _build.CSRC / "robust_agg.cu"
BUILD_DIR = _build.BUILD_DIR

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"median": 0, "trimmed_mean": 0, "fused_median_trimmed": 0}

_SYMBOL = {"median": "ra_median", "trimmed_mean": "ra_trimmed_mean",
           "fused_median_trimmed": "ra_fused"}
_LIB: Optional[ctypes.CDLL] = None
_LOAD_LOCK = threading.Lock()
_PAIRS: Dict[Tuple[int, Tuple[int, ...], torch.device], torch.Tensor] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    """Compile the kernels (once per source content) and return the shared
    library's path; nvcc's ``-Xptxas -v`` report goes to a ``.log`` file
    beside it."""
    return _build.build(SOURCE, BUILD_DIR)


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call).  Raises when CUDA
    or nvcc is missing."""
    global _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = _build.load(SOURCE, "ra_error_string", BUILD_DIR)
            for sym in _SYMBOL.values():
                fn = getattr(lib, sym)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected an (m, n) matrix, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    m, n = x.shape
    if not 1 <= m <= SN.NETWORK_MAX_M:
        raise ValueError(f"the kernels take 1 <= m <= {SN.NETWORK_MAX_M}, got m={m}")
    if n < 1:
        raise ValueError("the kernels need at least one coordinate")
    if not x.is_contiguous():
        raise ValueError("the kernels need a contiguous (m, n) matrix")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _pairs(prog: SN.SelectionProgram, device: torch.device) -> torch.Tensor:
    """The program's comparators as flat uint8 (i, j) pairs on ``device``,
    uploaded once per (m, ranks, device)."""
    key = (prog.m, prog.ranks, device)
    t = _PAIRS.get(key)
    if t is None:
        flat = [w for pair in prog.comparators for w in pair]
        t = _PAIRS[key] = torch.tensor(flat, dtype=torch.uint8).to(device)
    return t


def _launch(name: str, x: torch.Tensor, prog: SN.SelectionProgram, trim: int,
            med: Optional[torch.Tensor], tm: Optional[torch.Tensor]) -> None:
    fn = getattr(load(), _SYMBOL[name])
    m, n = x.shape
    pairs = _pairs(prog, x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), m, n, pairs.data_ptr(), prog.size, trim,
                 ptr(med), ptr(tm), int(x.dtype == torch.bfloat16), stream)
    _build.check_launch(load(), name, err)
    LAUNCHES[name] += 1


def _check_trim(m: int, trim: int) -> None:
    if not (0 <= trim and 2 * trim < m):
        raise ValueError(f"invalid trim {trim} for m={m}")


def median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of ``x`` (m, n) -> (n,), same dtype."""
    _check(x)
    if x.device.type == "cpu":
        return SN.median_select(x)
    out = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
    _launch("median", x, SN.median_program(x.shape[0]), 0, out, None)
    return out


def trimmed_mean(x: torch.Tensor, trim: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean of ``x`` (m, n) -> (n,) over the ranks
    [trim, m - trim)."""
    _check(x)
    _check_trim(x.shape[0], trim)
    if x.device.type == "cpu":
        return SN.trimmed_mean_select(x, trim)
    out = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
    _launch("trimmed_mean", x, SN.trimmed_program(x.shape[0], trim), trim, None, out)
    return out


def fused_median_trimmed(x: torch.Tensor, trim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(median, trimmed mean) of ``x`` (m, n) from one read of the rows."""
    _check(x)
    _check_trim(x.shape[0], trim)
    if x.device.type == "cpu":
        return SN.median_and_trimmed_select(x, trim)
    med = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
    tm = torch.empty_like(med)
    _launch("fused_median_trimmed", x, SN.fused_program(x.shape[0], trim), trim, med, tm)
    return med, tm
