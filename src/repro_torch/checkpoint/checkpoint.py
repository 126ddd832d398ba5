"""npy-based checkpointing for trees (dicts/tuples/lists) of tensors.

A checkpoint directory holds one ``leaf_XXXX.npy`` per tensor and a
``manifest.json`` mapping each leaf's path to its file, shape and dtype,
plus the step and an ``extra`` dict of JSON host state.

Round trips are exact: bfloat16 and the float8 formats (which numpy
cannot hold) are stored as their raw 16-bit and 8-bit patterns and
restored to their dtype bit for bit (NaN payloads included); every leaf
comes back at its RECORDED dtype on the template leaf's device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

# dtypes numpy cannot hold -> same-width ints
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
         torch.float8_e5m2: torch.uint8}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(ckpt_dir: str, tree, step: int = 0, extra: Optional[dict] = None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = {}
    for i, (path, t) in enumerate(tree_leaves_with_path(tree)):
        t = t.detach().cpu()
        fname = f"leaf_{i:04d}.npy"
        arr = (t.view(_BITS[t.dtype]) if t.dtype in _BITS else t).numpy()
        np.save(os.path.join(ckpt_dir, fname), arr)
        leaves[path] = {"file": fname, "shape": list(t.shape),
                        "dtype": _dtype_name(t.dtype)}
    manifest = {"step": step, "extra": extra or {}, "leaves": leaves}
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_extra(ckpt_dir: str) -> dict:
    """The ``extra`` metadata dict recorded at save time."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        return json.load(f).get("extra", {})


def restore(ckpt_dir: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a template tree): shapes
    must match, dtypes come from the manifest, devices from ``like``."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)

    def load(path: str, tmpl: torch.Tensor) -> torch.Tensor:
        meta = manifest["leaves"].get(path)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        t = torch.from_numpy(np.load(os.path.join(ckpt_dir, meta["file"])))
        dtype = getattr(torch, meta["dtype"])
        if dtype in _BITS:
            t = t.view(dtype)
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {path}: {tuple(t.shape)} vs "
                             f"{tuple(tmpl.shape)}")
        return t.to(device=tmpl.device, dtype=dtype)

    return tree_map_with_path(load, like), manifest["step"]
