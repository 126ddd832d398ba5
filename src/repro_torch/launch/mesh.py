"""Meshes of workers (the reference's ``repro.launch.mesh``).

The reference's debug mesh is ``jax.make_mesh`` over a host's forced
devices: ``make_debug_mesh(4, 1)`` is four data-parallel workers, the
paper's worker machines, with the robust aggregation across them.  The
port's debug mesh keeps those worker axes but puts the workers in one
process on one device (:class:`repro_torch.core.distributed.InProcessAxes`):
each worker computes its own gradient on its own batch shard, and the
collectives are operations on the worker-stacked values.

The production meshes (:func:`make_production_mesh`) run one worker a
process over a ``torch.distributed`` process group
(:class:`repro_torch.core.distributed.ProcessGroupAxes`), one card a rank,
as ``torchrun`` launches them.  Model parallelism (``model > 1``) comes
with a later slice and raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Tuple

import torch

from repro_torch.core.distributed import Collectives, InProcessAxes, ProcessGroupAxes
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes on this process's device; ``axes`` is the
    worker axes' collective implementation, ``rank`` this process's rank
    and ``per_rank`` whether it is one worker of a process group (False
    on the in-process debug mesh, rank 0 holding every worker)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    axes: Collectives
    rank: int = 0
    per_rank: bool = False

    def snapshot_dir(self, root: str) -> str:
        """Where this process keeps its state snapshots under ``root``:
        ``root`` itself on the debug mesh, ``root/rank{r}`` for every rank
        of a process group (each rank's error-feedback residuals are its
        own)."""
        return os.path.join(root, f"rank{self.rank}") if self.per_rank else root


def _refuse_model_axis(model: int) -> None:
    if model != 1:
        raise NotImplementedError(
            f"model axis {model}: tensor parallelism is not ported yet (ROADMAP queue A "
            "item 6, step 4); use model=1")


def make_debug_mesh(data: int = 4, model: int = 1, pod: int = 0, device="cuda") -> Mesh:
    """``data`` workers (``pod`` x ``data`` with pods) in one process on
    ``device``, and a model axis of size 1."""
    _refuse_model_axis(model)
    dev = resolve(device)
    names = ("pod", "data", "model") if pod else ("data", "model")
    shape = (pod, data, model) if pod else (data, model)
    if min(shape) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {dict(zip(names, shape))}")
    workers = {a: s for a, s in zip(names, shape) if a != "model"}
    return Mesh(names, shape, dev, InProcessAxes(workers, dev))


def make_production_mesh(*, multi_pod: bool = False, model: int = 1, device=None) -> Mesh:
    """One worker a rank of the ``torch.distributed`` process group.

    Joins the group from the environment ``torchrun`` sets (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` for the ranks of one host) unless
    one is initialised already.  NCCL on ``cuda:LOCAL_RANK``; gloo when the
    caller asks for ``device="cpu"``.  ``single`` is ``(data=world,
    model=1)``; ``multi_pod`` is ``(pod=world // LOCAL_WORLD_SIZE,
    data=LOCAL_WORLD_SIZE, model=1)``, a pod a host."""
    import torch.distributed as dist

    _refuse_model_axis(model)
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    dev = resolve("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no torch.distributed process group and {missing} unset: launch with "
                "torchrun (or set them) for a production mesh")
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", **kw)
    world = dist.get_world_size()
    if multi_pod:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if world % local_world:
            raise ValueError(f"world {world} is not whole hosts of {local_world} ranks")
        names, shape = ("pod", "data", "model"), (world // local_world, local_world, 1)
    else:
        names, shape = ("data", "model"), (world, 1)
    workers = {a: s for a, s in zip(names, shape) if a != "model"}
    return Mesh(names, shape, dev, ProcessGroupAxes(workers, dev), rank=dist.get_rank(),
                per_rank=True)


def worker_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a == "model")


def mesh_shape_dict(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def num_workers(mesh: Mesh) -> int:
    s = mesh_shape_dict(mesh)
    return math.prod(s[a] for a in worker_axes(mesh))
