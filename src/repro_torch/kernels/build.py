"""Build and load the port's hand-written CUDA sources.

Each ``csrc/*.cu`` file, and each source generated into the build
directory (which may include the headers in ``csrc/``), has a plain C
interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library named after
the source and the hash of its content, ``lib<stem>-<hash>.so``, in
``build/repro_torch/`` at the repository root, and loaded with ctypes.
nvcc's ``-Xptxas -v`` report (registers, spills) goes to a ``.log`` file
beside the library.  A library whose hash matches is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))


def nvcc(source: Path) -> str:
    """Path of ``nvcc``; raises naming ``source`` when the toolkit is missing."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            f"nvcc not found: the {source.stem} CUDA kernels are built from {source} "
            "at first use and need the CUDA toolkit")
    return path


def build(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` (once per content) and return the library's path."""
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    lib = build_dir / f"lib{source.stem}-{tag}.so"
    if lib.exists():
        return lib
    compiler = nvcc(source)
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def require_cuda(what: str) -> None:
    """Raise unless a CUDA device is present: CPU tensors take the kernels'
    plain versions and never need one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"the {what} CUDA kernels need a CUDA device "
            "(CPU tensors take the plain version)")


def load_library(lib_path: Path, error_fn: str) -> ctypes.CDLL:
    """Load a built library; ``error_fn`` names its ``const char* (int)``
    function that spells a CUDA error code (``lib.spell_error``)."""
    lib = ctypes.CDLL(str(lib_path))
    spell = getattr(lib, error_fn)
    spell.argtypes = [ctypes.c_int]
    spell.restype = ctypes.c_char_p
    lib.spell_error = spell
    return lib


def load(source: Path, error_fn: str, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build ``source`` if needed and load it (:func:`load_library`).
    Raises without CUDA."""
    require_cuda(source.stem)
    return load_library(build(source, build_dir), error_fn)


def launch_on(device: int, launch: Callable[[int], int]) -> int:
    """Call ``launch(stream)`` with the raw handle of the current stream of
    CUDA device ``device`` while it is the current device; returns its CUDA
    error code.  It switches devices only when it must and reads the raw
    handle without building a ``torch.cuda.Stream``: on small inputs the
    wrapper's host time is most of a call."""
    if device == _current_device():
        return launch(_raw_stream(device))
    with torch.cuda.device(device):
        return launch(_raw_stream(device))


_current_device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                      lambda idx: torch.cuda.current_stream(idx).cuda_stream)


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.spell_error(err).decode()} ({err})")
