"""Meshes of workers (the reference's ``repro.launch.mesh``).

The reference's debug mesh is ``jax.make_mesh`` over a host's forced
devices: ``make_debug_mesh(4, 1)`` is four data-parallel workers, the
paper's worker machines, with the robust aggregation across them.  The
port's debug mesh keeps those worker axes but puts the workers in one
process on one device (:class:`repro_torch.core.distributed.InProcessAxes`):
each worker computes its own gradient on its own batch shard, and the
collectives are operations on the worker-stacked values.

Model parallelism (``model > 1``) and the production meshes (a
``torch.distributed`` process group per host) come with later slices and
raise ``NotImplementedError`` naming them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core.distributed import InProcessAxes
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes, on one device; ``axes`` is the worker
    axes' collective implementation."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    axes: InProcessAxes


def make_debug_mesh(data: int = 4, model: int = 1, pod: int = 0, device="cuda") -> Mesh:
    """``data`` workers (``pod`` x ``data`` with pods) in one process on
    ``device``, and a model axis of size 1."""
    if model != 1:
        raise NotImplementedError(
            f"model axis {model}: tensor parallelism is not ported yet (ROADMAP queue A "
            "item 6); use model=1")
    dev = resolve(device)
    names = ("pod", "data", "model") if pod else ("data", "model")
    shape = (pod, data, model) if pod else (data, model)
    if min(shape) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {dict(zip(names, shape))}")
    workers = {a: s for a, s in zip(names, shape) if a != "model"}
    return Mesh(names, shape, dev, InProcessAxes(workers, dev))


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "production meshes run one process per card over a torch.distributed process "
        "group, which the next slice brings (ROADMAP queue A item 6); use "
        "make_debug_mesh")


def worker_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a == "model")


def mesh_shape_dict(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def num_workers(mesh: Mesh) -> int:
    s = mesh_shape_dict(mesh)
    return math.prod(s[a] for a in worker_axes(mesh))
