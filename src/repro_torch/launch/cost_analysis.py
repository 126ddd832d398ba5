"""Cost analysis of a rank's eager program (the reference's
``repro.launch.hlo_analysis``).

The reference parses the optimized, SPMD-partitioned HLO of a compiled
step and walks its call graph, multiplying loop bodies by their trip
counts.  The port has no HLO: a step is eager torch, so its costs are
counted as it runs, under one :class:`CostMode` (a ``TorchDispatchMode``).
Every layer runs, so there are no trip counts to recover.  Run under
``FakeTensorMode`` (:mod:`repro_torch.launch.dryrun`) the program
allocates nothing and touches no card; run on real tensors it counts the
same operations.

What it counts, per rank:

- ``flops``: 2·M·N·K for every matmul (and a convolution's or attention
  op's own formula), as ``torch.utils.flop_counter.FlopCounterMode``
  counts them, kept by the dtype of the operands (``flops_by_dtype``),
  because the roofline divides each dtype by its own peak;
- ``bytes``: the operand and result bytes of every aten op and of each
  kernel op, view and metadata ops skipped (a view moves nothing; an
  ``empty`` allocates without writing), an HBM-traffic approximation in
  the spirit of the reference's; a B1 launch on an (m, n) leaf counts
  (m + 1)·n·itemsize, the bytes its bound takes;
- ``collectives``: the output bytes of each ``c10d`` collective
  (all-gather, all-reduce, reduce-scatter, all-to-all, broadcast), by
  kind and by mesh axis (``collectives_by_axis``, the axes of the group
  it ran over); the reference's convention is output bytes, and the
  roofline and the report weight an all-reduce 2x;
- ``kernel_launches``: launches of each hand-written kernel op, under the
  names of the wrappers' ``LAUNCHES`` counters;
- ``peak_bytes``: the most bytes live at once in the storages the program
  allocates (each rounded up to the caching allocator's 512 bytes), a
  small tracker of our own: a storage's bytes are added when an op (not
  a view) first returns it and taken off when Python frees it.  Tensors
  made before the mode was entered count only once passed to
  :meth:`CostMode.track` (or once an op writes them in place).
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: the caching allocator's granularity (bytes)
ALLOC_ROUND = 512

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "broadcast")

# c10d op name fragments -> the reference's collective kinds
_C10D_KINDS = (("allgather", "all-gather"), ("all_gather", "all-gather"),
               ("allreduce", "all-reduce"), ("reduce_scatter", "reduce-scatter"),
               ("alltoall", "all-to-all"), ("broadcast", "broadcast"))

# ops that allocate or relabel without moving data
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "alias", "lift_fresh", "_local_scalar_dense", "resize_", "set_",
             "_has_compatible_shallow_copy_type", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_same_size", "record_stream"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class CostMode(TorchDispatchMode):
    """Counts the program that runs inside it (module docstring).  ``axes``
    maps a process group's name to the mesh axes it spans
    (:func:`group_axes`); a collective over another group counts under
    ``"other"``."""

    def __init__(self, axes: Optional[Dict[str, str]] = None):
        super().__init__()
        self.axes = dict(axes or {})
        self.flops_by_dtype: Dict[str, float] = collections.defaultdict(float)
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collectives_by_axis: Dict[str, Dict[str, float]] = {}
        self.kernel_launches: Dict[str, int] = collections.defaultdict(int)
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._kinds: Dict[torch._ops.OpOverload, str] = {}

    # -- memory

    def track(self, tree) -> None:
        """Count the storages of the tensors in ``tree`` as live (arguments
        made before the mode was entered)."""
        for t in _tensors(tree):
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        size = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._storages[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- classification

    def _kind(self, func) -> str:
        kind = self._kinds.get(func)
        if kind is None:
            ns, name = func.namespace, func._schema.name.split("::")[-1]
            if ns == "c10d":
                kind = next((k for frag, k in _C10D_KINDS if frag in name), "skip")
            elif ns == "repro_torch":
                kind = "kernel"
            elif func.is_view or ns == "prim":
                kind = "view"  # a view's storage is its base's; metadata
            elif name in _NO_BYTES:
                kind = "alloc"  # allocates (or relabels) without moving data
            else:
                kind = "op"
            self._kinds[func] = kind
        return kind

    def _axis(self, args) -> str:
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = torch.distributed.ProcessGroup.unbox(a)
                except (RuntimeError, TypeError):
                    continue
                return self.axes.get(pg.group_name, "other")
        return "other"

    # -- the mode

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = self._kind(func)
        if kind == "view":
            return out
        outs = _tensors(out)
        for t in outs:
            self._add(t)
        if kind in ("alloc", "skip"):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            ins = _tensors(args)
            dtype = _dtype_name(ins[0].dtype) if ins else "float32"
            self.flops_by_dtype[dtype] += float(flop_registry[packet](*args, **kwargs,
                                                                      out_val=out))
        if kind in COLLECTIVES:
            # the output tensors (an in-place collective's are its inputs)
            first = args[0]
            b = float(sum(_nbytes(t) for t in _tensors(first)))
            self.collectives[kind] += b
            per = self.collectives_by_axis.setdefault(self._axis(args), {})
            per[kind] = per.get(kind, 0.0) + b
            self.bytes += b
            return out
        self.bytes += float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                            + sum(_nbytes(t) for t in outs))
        if kind == "kernel":
            name = func._schema.name.split("::")[-1]
            if name == "select":
                from repro_torch.kernels import robust_agg

                self.kernel_launches[args[0]] += robust_agg.launches_for(len(args[2]))
            else:
                self.kernel_launches[name] += 1
        return out

    # -- results

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    def result(self) -> dict:
        coll = dict(self.collectives)
        return {"flops": self.flops, "flops_by_dtype": dict(self.flops_by_dtype),
                "bytes": self.bytes, "collectives": coll,
                "collective_bytes": wire_bytes(coll),
                "collectives_by_axis": {a: dict(c) for a, c in
                                        sorted(self.collectives_by_axis.items())},
                "kernel_launches": dict(self.kernel_launches),
                "peak_bytes": self.peak}


def wire_bytes(coll: Dict[str, float]) -> float:
    """Bytes on the wire of collectives' output bytes by kind: a ring
    all-reduce moves about twice its output (reduce-scatter and all-gather
    phases), the others about once."""
    return float(sum(v * (2.0 if k == "all-reduce" else 1.0)
                     for k, v in coll.items() if k != "total"))


def group_axes(mesh) -> Dict[str, str]:
    """``{process group name: axes label}`` of a process-group mesh's
    groups (``"data"``, ``"model"``, ``"pod+data"``, ...); empty for the
    in-process mesh, whose collectives are no ``c10d`` calls."""
    if not getattr(mesh, "per_rank", False):
        return {}
    return {g.group_name: "+".join(run) for run, g in mesh.axes.groups.items()}


def analyze(fn, *args, axes: Optional[Dict[str, str]] = None, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` counted under one :class:`CostMode`; the
    counts (:meth:`CostMode.result`) and ``"out"``, what ``fn`` returned."""
    with CostMode(axes) as mode:
        out = fn(*args, **kwargs)
    res = mode.result()
    res["out"] = out
    return res
