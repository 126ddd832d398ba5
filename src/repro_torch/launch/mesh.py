"""Meshes of workers (the reference's ``repro.launch.mesh``).

The reference's debug mesh is ``jax.make_mesh`` over a host's forced
devices: ``make_debug_mesh(4, 1)`` is four data-parallel workers, the
paper's worker machines, with the robust aggregation across them.  The
port's debug mesh keeps those worker axes but puts the workers in one
process on one device (:class:`repro_torch.core.distributed.InProcessAxes`):
each worker computes its own gradient on its own batch shard, and the
collectives are operations on the worker-stacked values.

The production meshes (:func:`make_production_mesh`) run one rank a
process over a ``torch.distributed`` process group
(:class:`repro_torch.core.distributed.ProcessGroupAxes`), one card a rank,
as ``torchrun`` launches them.

The ``model`` axis is tensor parallelism: every split weight is cut into
``model`` shards and the layers' model ranks meet through the model-axis
collectives.  On the debug mesh the model ranks of a layer run one after
the other in the process (the params stay the global view); under a
process group world = workers × model, ranks row-major over the axes (a
worker's model ranks consecutive, so under ``multi`` a pod is a host and
the model axis lies inside it).  :func:`worker_axes`,
:func:`num_workers` and the batch rows count workers only.
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


def make_debug_mesh(data: int = 4, model: int = 1, pod: int = 0, device="cuda") -> Mesh:
    """``data`` workers (``pod`` x ``data`` with pods) in one process on
    ``device``, each computing its ``model`` ranks one after the other."""
    dev = resolve(device)
    names = ("pod", "data", "model") if pod else ("data", "model")
    shape = (pod, data, model) if pod else (data, model)
    if min(shape) < 1:
        raise ValueError(f"mesh sizes must be >= 1, got {dict(zip(names, shape))}")
    return Mesh(names, shape, dev, InProcessAxes(dict(zip(names, shape)), dev))


def make_production_mesh(*, multi_pod: bool = False, model: int = 1, device=None) -> Mesh:
    """One worker a rank of the ``torch.distributed`` process group.

    Joins the group from the environment ``torchrun`` sets (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` for the ranks of one host) unless
    one is initialised already.  NCCL on ``cuda:LOCAL_RANK``; gloo when the
    caller asks for ``device="cpu"``.  ``single`` is ``(data=world //
    model, model)``; ``multi_pod`` is ``(pod=world // LOCAL_WORLD_SIZE,
    data=LOCAL_WORLD_SIZE // model, model)``, a pod a host with its model
    ranks inside it."""
    import torch.distributed as dist

    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
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
        if local_world % model:
            raise ValueError(f"a host of {local_world} ranks does not hold model axes of "
                             f"{model}")
        names = ("pod", "data", "model")
        shape = (world // local_world, local_world // model, model)
    else:
        if world % model:
            raise ValueError(f"world {world} is not whole model axes of {model} ranks")
        names, shape = ("data", "model"), (world // model, model)
    # the model axis takes part in the groups only when it splits anything
    sizes = {a: s for a, s in zip(names, shape) if a != "model" or s > 1}
    return Mesh(names, shape, dev, ProcessGroupAxes(sizes, dev), rank=dist.get_rank(),
                per_rank=True)


def worker_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a == "model")


def model_size(mesh: Mesh) -> int:
    return mesh_shape_dict(mesh).get("model", 1)


def model_rank(mesh: Mesh) -> int:
    """This process's model coordinate under a process group (0 on the
    debug mesh, whose process computes every model rank)."""
    return getattr(mesh.axes, "coords", {}).get("model", 0) if mesh.per_rank else 0


def worker_index(mesh: Mesh) -> int:
    """This process's worker (its linear index over the worker axes) under
    a process group; 0 on the debug mesh, whose process holds every
    worker."""
    if not mesh.per_rank:
        return 0
    coords = getattr(mesh.axes, "coords", {})
    w = 0
    for a in worker_axes(mesh):
        w = w * mesh_shape_dict(mesh)[a] + coords.get(a, 0)
    return w


def mesh_shape_dict(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def num_workers(mesh: Mesh) -> int:
    s = mesh_shape_dict(mesh)
    return math.prod(s[a] for a in worker_axes(mesh))
