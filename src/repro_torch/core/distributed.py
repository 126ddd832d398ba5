"""Distributed robust reductions — the paper's aggregation as collectives
over a worker axis (the reference's ``repro.core.distributed``).

The reference's strategies run inside a ``jax.shard_map`` body whose
manual axes are the worker axes (``('data',)`` or ``('pod', 'data')``)
and talk to each other through ``jax.lax`` collectives.  Here every
strategy body is written once over :class:`Collectives`, a small interface
with the same calls (``size``, ``index``, ``all_gather``, ``all_to_all``,
``psum``, ``pmin``, ``pmax``), and takes the implementation as an
argument.  Two implementations:

- :class:`InProcessAxes` — m workers that live in one process on one
  device: a value each worker holds for itself (*varying*) is one tensor
  whose leading dims index the workers (``vshape``: ``(m,)``, or ``(pods,
  data)`` for two axes) followed by the worker's own shape; a value every
  worker holds alike (*replicated*) has no worker dims.
- :class:`ProcessGroupAxes` — one worker a process of a
  ``torch.distributed`` process group (NCCL on the card, gloo on the CPU):
  a varying value is the rank's own tensor (``vshape`` ``()``), and the
  collectives are the backend's over one subgroup per slice of each
  worker axis.  Order statistics are bitwise the in-process ones on the
  same rows; sums (``psum``, the sketch's bin sums) are added in the
  backend's order, so means agree to a tolerance.

Strategies (identical estimators to the reference's; see its module doc
for the byte costs on a real interconnect):

``gather``        all-gather the m per-worker gradients, aggregate
                  coordinate-wise.  In-process the gather is a view of the
                  worker-stacked gradients, and all leaves take ONE
                  aggregation call (one B1 / B2 launch for up to 16 leaves).
``bucketed``      split the flat gradient into m buckets, ``all_to_all``
                  them, aggregate your bucket over the m rows,
                  ``all_gather`` the buckets.  In-process the
                  ``all_to_all`` is a transpose of the (m, m, G/m) view, so
                  every destination's bucket is a slice of one (m, G)
                  buffer and the step is one aggregation of it.
``rs``            ``bucketed`` without the final gather (the FSDP backward).
``chunked``       histogram sketch: per-coordinate range by ``pmin`` /
                  ``pmax`` (in-process: one B4 launch over the m rows),
                  bin counts (and sums) psummed over the workers
                  (in-process: one B5 launch over the m rows a chunk).
                  Error <= one bin width.
``psum``          the plain data-parallel mean, no robustness.
``hierarchical``  median of medians: within the inner axis, then across
                  the outer one (a different estimator).

The robust FSDP parameter gather (:func:`make_robust_param_gather_dim`) is
an autograd ``Function`` over the same interface: all_gather in the
forward, ``rs`` of the cotangent (:func:`robust_reduce_scatter_dims`) in
the backward.

The model axis (tensor parallelism): a mesh's ``model`` ranks each hold a
shard of every split weight, and the layers between them meet through the
``model_*`` calls of :class:`Collectives` (Megatron's f and g, a gather,
a max).  :class:`InProcessAxes` computes every model rank of a layer one
after the other on its device, from chunks of the global view, and sums
their partial outputs in rank order; :class:`ProcessGroupAxes` computes
its own rank's and joins the others through three autograd ``Function``s
over the model subgroup: Megatron's f, copy to model (identity forward,
psum backward), its g, reduce from model (psum forward, identity
backward), and gather from model (all_gather forward, the rank's chunk
backward).  A
sum of two partials is the same in either order, so at model size 2 the
two give the same bits.  The worker axes' strategies are unchanged: each
model rank aggregates its own leaves over the workers of its model
coordinate.  Beside them: ``model_cut`` (a whole tensor to the rank's
chunk, its gradient gathered: fsdp's leaves whose model axis yields, and
sequence parallelism's split of the residual, which ``model_full``
gathers back), ``whole_rows`` (the whole leaf's shape and the rank's cut
of it, over which a randomized payload is drawn), and ``seq_enter`` /
``seq_reduce``, Megatron-SP's pair (in process the global view, whose
reduce sums each rank's rows in turn; under a process group autograd
``Function``s whose reduce-scatter is an all-reduce and the rank's chunk,
as gloo has no reduce-scatter).  The split mixers add two: ``model_columns``,
an all-to-all that hands each rank the columns it wants of an activation
the ranks hold in even chunks (the ``ssm`` mixer's packed in-projection to
each rank's heads; its backward the reverse all-to-all, a column several
ranks read summed in rank order), and ``model_gather``, an all-gather whose
backward is a reduce-scatter (the ``rec`` mixer's conv output, which each
rank's gate columns read whole).

Byzantine simulation as in the reference: gradient-space attacks run where
the per-worker rows are visible (after the gather / all_to_all), by the
rows' worker index against the attack's Byzantine cut; the chunked and
psum strategies replace a Byzantine worker's own row before the
collective, with the honest statistics psummed over the honest workers.

Attack keys are integer seeds: randomized payloads draw from
``repro_torch.rng.generator(key[, worker])`` on the data's device.
"""
from __future__ import annotations

import collections
import itertools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import rng, trace
from repro_torch.attacks import base as attack_base
from repro_torch.attacks import engine as attack_engine
from repro_torch.core import aggregators
from repro_torch.core.attacks import AttackConfig, apply_gradient_attack, byzantine_payload
from repro_torch.device import resolve
from repro_torch.kernels import histogram_agg as H
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

#: coordinates a chunk of the chunked strategy sketches at once: results do
#: not depend on it (every coordinate is binned on its own), and far above
#: the reference's 16,384 it keeps a full-width gradient to a few thousand
#: B5 launches; the (nbins, chunk) f32 counts of 256 bins are 1 GiB.
COORD_CHUNK = 1 << 20


# --------------------------------------------------------------------------
# the collective interface and its in-process implementation
# --------------------------------------------------------------------------


class Collectives:
    """The worker-axis collectives the strategy bodies are written over.

    ``names`` is a tuple of worker-axis names, outermost first.  A value
    entering a collective over ``names`` varies over ``outer(names) +
    names`` and is laid out with ``vshape`` of those axes in front of the
    worker's own shape; the collective's result varies over
    ``outer(names)`` only (``all_to_all`` keeps it varying over every axis
    of its ``varying`` argument).
    """

    def size(self, names: Sequence[str]) -> int:
        raise NotImplementedError

    def vshape(self, names: Sequence[str]) -> Tuple[int, ...]:
        """Leading dims of a value varying over ``names``."""
        raise NotImplementedError

    def outer(self, names: Sequence[str]) -> Tuple[str, ...]:
        """The other axes a value entering a collective over ``names``
        varies over."""
        raise NotImplementedError

    def index(self, names: Sequence[str]) -> torch.Tensor:
        """Each worker's linear index over ``names`` (row-major, the order
        ``all_gather`` stacks rows in), as an int64 varying value."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, names: Sequence[str], tiled: bool = False):
        """Every worker's ``x`` stacked along a new dim 0 (``tiled``:
        concatenated along dim 0)."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor, name: str, axis: int, varying: Sequence[str]):
        """Tiled all-to-all over one axis: local dim ``axis`` is split into
        ``size((name,))`` chunks, chunk j goes to worker j, and the chunks
        received are concatenated in source order.  ``x`` varies over
        ``varying``."""
        raise NotImplementedError

    def psum(self, x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        raise NotImplementedError

    def pminmax(self, x: torch.Tensor, names: Sequence[str]):
        """Per-coordinate float32 (min, max) over the workers' ``x`` with
        ``jnp.minimum`` / ``jnp.maximum`` rules (NaN propagates, -0 < +0)."""
        raise NotImplementedError

    def pmin(self, x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        return self.pminmax(x, names)[0]

    def pmax(self, x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        return self.pminmax(x, names)[1]

    def psum_histogram(self, x: torch.Tensor, lo, width, nbins: int, with_sums: bool,
                       names: Sequence[str]):
        """psum over the workers of each worker's one-hot bin counts (and
        sums) of its row ``x`` (n,): two (nbins, n) float32 (sums None
        without ``with_sums``)."""
        raise NotImplementedError

    def map_workers(self, fn: Callable, names: Sequence[str], *xs, out=None):
        """``fn(worker, *locals)`` on each worker, ``xs`` trees of values
        varying over ``outer(names) + names`` and ``worker`` the linear
        index over ``names``.  Returns the results as varying values,
        written into the tree ``out`` when given (same layout)."""
        raise NotImplementedError

    def local_rows(self, x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        """Each worker's block of a global batch ``x`` (b, ...) every worker
        holds alike: worker w (linear index over ``names``, every worker
        axis) takes rows [w·b/m, (w+1)·b/m), as a value varying over
        ``names``."""
        raise NotImplementedError

    # -- the model axis.  These defaults are the in-process ones: every
    # model rank is computed here, from chunks of the global view, and the
    # partial results meet in rank order.  At model size 1 each is the
    # identity.

    #: the model axis' size
    model: int = 1

    def model_ranks(self) -> Sequence[int]:
        """The model ranks this process computes, in order."""
        return range(self.model)

    def model_shard(self, w: torch.Tensor, dim: int, k: int) -> torch.Tensor:
        """Model rank ``k``'s shard of a weight split along ``dim``: chunk
        ``k`` of the global view, contiguous (a strided view would send
        the product that reads it down another BLAS path)."""
        return w if self.model == 1 else w.chunk(self.model, dim)[k].contiguous()

    def model_split(self, x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
        """Chunk ``k`` along ``dim`` of an activation every model rank
        holds alike."""
        return x if self.model == 1 else x.chunk(self.model, dim)[k].contiguous()

    def model_enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: an activation every rank holds alike, about to be
        read by each rank's shard; its gradient is the sum of the ranks'.
        Each rank reads it through :meth:`model_local`.  In process a node
        of its own, whose gradient is the ranks' summed in rank order
        (:class:`_EnterInProcess`) before it meets any other, as the psum
        is under a process group."""
        if self.model == 1:
            return x
        reads = [None] * self.model  # each rank's gradient, filled by model_local's reads
        y = _EnterInProcess.apply(x, reads)
        y._model_reads = reads
        return y

    def model_local(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """Rank ``k``'s read of an entered activation: in process a node of
        its own whose gradient (the sum of the rank's uses, however many
        reads) waits in the rank's slot until the entered node adds the
        ranks' in rank order, as on a rank of a process group.  Read the
        entered tensor itself: a view of it has no slots, and its read's
        gradient reaches the entered node in autograd's order (the same
        sum, rounded otherwise)."""
        if self.model == 1:
            return x
        reads = getattr(x, "_model_reads", None)
        return x.view_as(x) if reads is None else _ReadInProcess.apply(x, reads, k)

    def model_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Megatron's g: the sum of the ranks' partial results, in rank
        order."""
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def model_cat(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The ranks' pieces of an activation concatenated along ``dim``."""
        return parts[0] if len(parts) == 1 else torch.cat(list(parts), dim)

    def model_full(self, w: torch.Tensor, dim: int, n: Optional[int] = None) -> torch.Tensor:
        """The whole of a weight (or an activation) split along ``dim``, ``n``
        long (default: the ranks' chunks end to end, no padding), for a
        computation every rank runs alike (in process the global view is
        whole already); its gradient is kept as the rank's chunk."""
        return w

    def model_gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The ranks' pieces of an activation concatenated along ``dim``, read
        by each rank's own computation through :meth:`model_local`: an
        all-gather whose gradient is the ranks' summed and the rank's chunk
        kept (a reduce-scatter).  In process the concatenation, entered."""
        return self.model_enter(self.model_cat(parts, dim))

    def model_columns(self, parts: Sequence[torch.Tensor], dim: int,
                      wants: Sequence[Sequence[Tuple[int, int]]]) -> list:
        """An all-to-all over the model axis: the ranks hold an activation in
        even chunks along ``dim`` (``parts``, the ranks' this process
        computes, in rank order), and each rank ``k`` gets the columns of
        ``wants[k]`` ((start, stop) ranges of the whole, ascending),
        concatenated; a column several ranks want goes to each of them, and a
        rank that wants none gets a zero-width tensor.  Its gradient goes
        back the same way, a column's the ranks' that read it summed (under
        a process group in rank order).  Returns the results of the ranks
        this process computes, in order; in process each rank's columns are
        cut from the chunks concatenated."""
        whole = self.model_cat(parts, dim)
        return [torch.cat([whole.narrow(dim, a, b - a) for a, b in wants[k]], dim)
                if wants[k] else whole.narrow(dim, 0, 0) for k in self.model_ranks()]

    def model_max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The element-wise max of the ranks' (detached) parts."""
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, p)
        return acc

    #: whether this process holds a model rank's shards of a split leaf
    #: (a process group) rather than the global view
    holds_shards: bool = False

    def model_cut(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's part of a tensor every model rank holds whole
        alike, along ``dim``: in process the whole (the global view); under
        a process group the rank's chunk, ceil(n / model) long (padded past
        the end, as GSPMD pads an uneven split), whose gradient is the whole
        one gathered from the ranks' chunks."""
        return w

    def whole_rows(self, shape, dim: Optional[int]):
        """For a tensor of ``shape`` that this process holds of a leaf split
        over the model axis along ``dim`` (None or -1: whole): ``(the whole
        leaf's shape, cut)``, where ``cut`` takes this process's part of a
        tensor of the whole shape, or None where the process holds the
        whole (in process, the global view)."""
        return None

    # -- sequence parallelism: between the layers of a super-block the
    # residual is split over the model axis along its dim ``dim`` (S, of
    # whole size ``n``) as :meth:`model_cut` splits it, and gathered back
    # for a computation every rank runs alike by :meth:`model_full`.  In
    # process the global view of the split residual is the whole residual.

    def seq_enter(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """Megatron-SP's ``enter``: the whole activation from the ranks' rows
        (an all-gather), read by each rank's shard through
        :meth:`model_local`; its gradient the ranks' summed and scattered
        (a reduce-scatter).  In process :meth:`model_enter`."""
        return self.model_enter(x)

    def seq_reduce(self, parts: Sequence[torch.Tensor], dim: int, n: int) -> torch.Tensor:
        """Megatron-SP's ``reduce``: the sum of the ranks' partial results,
        scattered over the ranks' rows (a reduce-scatter; its gradient an
        all-gather).  In process each rank's chunk of rows in turn, the
        partials summed in rank order: the global view of the rows."""
        if self.model == 1:
            return self.model_sum(parts)
        c = -(-n // self.model)
        rows = [(k * c, min((k + 1) * c, n)) for k in range(self.model) if k * c < n]
        return torch.cat([self.model_sum([p.narrow(dim, a, b - a) for p in parts])
                          for a, b in rows], dim)

    def seq_scale(self, xhat: torch.Tensor, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """``xhat · t`` of a norm over the split residual's rows (the scale
        ``t`` broadcast over them), whose gradient in ``t`` is the one of
        the whole rows: in process the rows are whole already."""
        return xhat * t

    def leaf_row_sum(self, x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """Each row's sum of a per-coordinate (m, ...) tensor of one leaf,
        over all the leaf's coordinates: its other model shards' too when
        the leaf is split along ``dim`` (of the leaf).  In process the
        global view's chunks are summed one by one and added in rank
        order, as a psum over the model axis adds the ranks' sums."""
        m = x.shape[0]
        if self.model == 1 or dim is None or dim < 0:
            return x.reshape(m, -1).sum(dim=1)
        return self.model_sum([c.reshape(m, -1).sum(dim=1)
                               for c in x.chunk(self.model, 1 + dim)])


class _NamedAxes(Collectives):
    """Axis bookkeeping shared by the implementations: ``sizes`` maps the
    mesh axes, outermost first, to their sizes."""

    def __init__(self, sizes: Dict[str, int]):
        self.sizes = dict(sizes)
        self.order = tuple(self.sizes)
        self.model = self.sizes.get("model", 1)
        self.calls = collections.Counter()

    def _axes(self, names) -> Tuple[str, ...]:
        names = tuple(names)
        pos = [self.order.index(a) for a in names]  # ValueError on an unknown axis
        if pos and pos != list(range(pos[0], pos[0] + len(pos))):
            raise ValueError(f"axes {names} are not consecutive mesh axes of {self.order}")
        return names

    def size(self, names) -> int:
        return math.prod(self.sizes[a] for a in self._axes(names))

    def outer(self, names) -> Tuple[str, ...]:
        names = self._axes(names)
        return self.order[:self.order.index(names[0])] if names else ()

    def _block(self, x, names) -> int:
        """Rows a worker takes of the global batch ``x``."""
        m, b = self.size(names), x.shape[0]
        if b % m:
            raise ValueError(f"global batch {b} does not split over {m} workers")
        return b // m


class InProcessAxes(_NamedAxes):
    """m workers in one process on one device: varying values are
    worker-stacked tensors.  A gather is a view of the stack, an
    all-to-all a transpose, a psum a sum over the worker dims in worker
    order; ``pminmax`` is one B4 launch and ``psum_histogram`` one B5
    launch over the stacked rows.  ``calls`` counts the collectives by
    name (the reference's tests count them in the jaxpr).

    A ``model`` entry of ``sizes`` is the model axis: it is not stacked
    (a value is the global view), and each layer computes its model ranks
    one after the other (the ``model_*`` calls)."""

    def __init__(self, sizes: Dict[str, int], device="cuda"):
        super().__init__({a: s for a, s in sizes.items() if a != "model"})
        self.model = int(sizes.get("model", 1))
        self.device = resolve(device)

    def vshape(self, names) -> Tuple[int, ...]:
        return tuple(self.sizes[a] for a in self._axes(names))

    def local_rows(self, x, names):
        return x.reshape(self.vshape(names) + (self._block(x, names),) + x.shape[1:])

    def _split(self, x, names):
        """(outer vshape, size over names, the local shape) of ``x``."""
        vo = self.vshape(self.outer(names))
        vn = self.vshape(names)
        if tuple(x.shape[:len(vo) + len(vn)]) != vo + vn:
            raise ValueError(f"value of shape {tuple(x.shape)} does not vary over "
                             f"{self.outer(names) + tuple(names)} {vo + vn}")
        return vo, math.prod(vn), tuple(x.shape[len(vo) + len(vn):])

    def index(self, names) -> torch.Tensor:
        vs = self.vshape(self.outer(names) + self._axes(names))
        idx = torch.arange(self.size(names), device=self.device)
        return idx.reshape(self.vshape(names)).expand(vs)

    def all_gather(self, x, names, tiled=False):
        self.calls["all_gather"] += 1
        vo, m, local = self._split(x, names)
        if tiled:
            return x.reshape(vo + (m * local[0],) + local[1:])
        return x.reshape(vo + (m,) + local)

    def all_to_all(self, x, name, axis, varying):
        self.calls["all_to_all"] += 1
        varying = self._axes(varying)
        p, q = varying.index(name), len(varying) + axis
        s = self.sizes[name]
        if x.shape[q] % s:
            raise ValueError(f"all_to_all: dim {axis} of size {x.shape[q]} does not split "
                             f"over {s} workers")
        return x.unflatten(q, (s, x.shape[q] // s)).transpose(p, q).flatten(q, q + 1)

    def psum(self, x, names):
        self.calls["psum"] += 1
        vo, m, local = self._split(x, names)
        rows = x.reshape(vo + (m,) + local).movedim(len(vo), 0)
        acc = rows[0]
        for i in range(1, m):  # in worker order
            acc = acc + rows[i]
        return acc

    def _rows(self, x, names):
        vo, m, local = self._split(x, names)
        if vo:
            raise ValueError("in-process pminmax / psum_histogram need every worker axis")
        return x.reshape(m, -1).contiguous(), local

    def pminmax(self, x, names):
        self.calls["pminmax"] += 1
        rows, local = self._rows(x, names)
        lo, hi = H.minmax(rows if rows.dtype in (torch.float32, torch.bfloat16)
                          else rows.float())
        return lo.reshape(local), hi.reshape(local)

    def psum_histogram(self, x, lo, width, nbins, with_sums, names):
        self.calls["psum"] += 1
        rows, _ = self._rows(x, names)
        return H.histogram(rows, lo, width, nbins, with_sums)

    def map_workers(self, fn, names, *xs, out=None):
        names = self._axes(names)
        vs = self.vshape(self.outer(names) + names)
        results = []
        for idx in itertools.product(*(range(s) for s in vs)):
            w = 0
            for a, i in zip(names, idx[len(idx) - len(names):]):
                w = w * self.sizes[a] + i
            res = fn(w, *(tree_map(lambda t: t[idx], x) for x in xs))
            if out is not None:
                with trace.span("worker.stack"):
                    tree_map(lambda o, r: o[idx].copy_(r), out, res)
            else:
                results.append(res)
        if out is not None:
            return out
        leaves = [tree_leaves(r) for r in results]
        stacked = [torch.stack(col).reshape(vs + tuple(col[0].shape)) for col in zip(*leaves)]
        return tree_unflatten_like(results[0], stacked)


class ProcessGroupAxes(_NamedAxes):
    """One worker a rank of the initialised ``torch.distributed`` process
    group: ``sizes`` lays the ranks out row-major over the worker axes
    (``{"data": world}`` or ``{"pod": P, "data": D}``), and a varying value
    is this rank's own tensor (``vshape`` ``()``).

    The constructor makes one subgroup for every slice of every run of
    consecutive axes, every rank calling ``new_group`` for every group in
    the same order (made lazily they would deadlock), and runs one
    all-reduce on each group this rank is in, so that NCCL's communicators
    exist before any collective a caller times or guards.  ``all_gather``
    and ``all_to_all`` move the bits as they are (``all_gather_single``
    where torch has it, else ``all_gather_into_tensor``;
    ``all_to_all_single``), so order statistics of gathered rows are
    bitwise the in-process ones.  ``psum`` is a SUM all-reduce, whose order
    the backend fixes, not the worker order.  ``pminmax`` gathers the rows
    and runs :func:`histogram_agg.minmax` on them (B4 on the card): a
    backend MIN / MAX does not promise ``jnp.minimum``'s NaN and ±0 rules.
    ``psum_histogram`` bins this rank's own row (B5 on the card) and
    all-reduces the counts (exact: integers below 2^24 in f32) and the
    sums.  ``calls`` counts the collectives by name, as
    :class:`InProcessAxes` does.

    With a ``model`` axis (``{"data": D, "model": M}``, ranks row-major as
    ``jax.make_mesh`` lays devices out, so a worker's M model ranks are
    consecutive) the worker-axis groups are the ranks of one model
    coordinate, and the ``model_*`` calls run over this rank's
    ``("model",)`` group through the autograd ``Function``s below."""

    def __init__(self, sizes: Dict[str, int], device="cuda"):
        import torch.distributed as dist

        super().__init__(sizes)
        self.device = resolve(device)
        self.holds_shards = self.model > 1
        self.rank, world = dist.get_rank(), dist.get_world_size()
        if math.prod(self.sizes.values()) != world:
            raise ValueError(f"axes {self.sizes} do not lay out a world of {world} ranks")
        coords = [self._unravel(r) for r in range(world)]
        self.coords = coords[self.rank]
        self.groups = {}  # consecutive axes -> this rank's group over them
        for i in range(len(self.order)):
            for j in range(i + 1, len(self.order) + 1):
                run = self.order[i:j]
                slices: Dict[tuple, list] = {}  # the other axes' coordinates -> ranks
                for r, c in enumerate(coords):
                    key = tuple(c[a] for a in self.order if a not in run)
                    slices.setdefault(key, []).append(r)
                for ranks in slices.values():  # row-major over ``run``: ranks ascend
                    group = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                    if self.rank in ranks:
                        self.groups[run] = group
        for group in self.groups.values():  # the same global order on every rank
            dist.all_reduce(torch.zeros(1, device=self.device), group=group)

    def _unravel(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.order):
            rank, out[a] = divmod(rank, self.sizes[a])
        return out

    def vshape(self, names) -> Tuple[int, ...]:
        self._axes(names)
        return ()

    def _group(self, names):
        return self.groups[self._axes(names)]

    def _linear(self, names) -> int:
        w = 0
        for a in self._axes(names):
            w = w * self.sizes[a] + self.coords[a]
        return w

    def index(self, names) -> torch.Tensor:
        return torch.full((), self._linear(names), dtype=torch.int64, device=self.device)

    def local_rows(self, x, names):
        n = self._block(x, names)
        w = self._linear(names)
        return x[w * n:(w + 1) * n]

    def _gather(self, x, names) -> torch.Tensor:
        """(m, ...) every worker's ``x`` over ``names``, in worker order."""
        import torch.distributed as dist

        m = self.size(names)
        x = x.contiguous()
        out = torch.empty((m * x.numel(),), dtype=x.dtype, device=x.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, x.reshape(-1), group=self._group(names))
        return out.reshape((m,) + tuple(x.shape))

    def all_gather(self, x, names, tiled=False):
        self.calls["all_gather"] += 1
        rows = self._gather(x, names)
        return rows.flatten(0, 1) if tiled else rows

    def all_to_all(self, x, name, axis, varying):
        import torch.distributed as dist

        self.calls["all_to_all"] += 1
        self._axes(varying)
        s = self.sizes[name]
        if x.shape[axis] % s:
            raise ValueError(f"all_to_all: dim {axis} of size {x.shape[axis]} does not split "
                             f"over {s} workers")
        send = x.movedim(axis, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._group((name,)))
        return recv.movedim(0, axis)

    def psum(self, x, names):
        import torch.distributed as dist

        self.calls["psum"] += 1
        acc = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=self._group(names))
        return acc

    def pminmax(self, x, names):
        self.calls["pminmax"] += 1
        rows = self._gather(x.reshape(-1), names)
        lo, hi = H.minmax(rows if rows.dtype in (torch.float32, torch.bfloat16)
                          else rows.float())
        return lo.reshape(x.shape), hi.reshape(x.shape)

    def psum_histogram(self, x, lo, width, nbins, with_sums, names):
        import torch.distributed as dist

        self.calls["psum"] += 1
        counts, sums = H.histogram(x.reshape(1, -1).contiguous(), lo, width, nbins, with_sums)
        group = self._group(names)
        for t in (counts,) if sums is None else (counts, sums):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return counts, sums

    def map_workers(self, fn, names, *xs, out=None):
        res = fn(self._linear(names), *xs)
        if out is None:
            return res
        with trace.span("worker.stack"):
            tree_map(lambda o, r: o.copy_(r), out, res)
        return out

    # -- the model axis: this rank's shard, the others through the group

    def model_ranks(self):
        return (self.coords["model"],) if self.model > 1 else (0,)

    def model_shard(self, w, dim, k):
        return w  # a rank holds its shards

    def model_enter(self, x):
        return x if self.model == 1 else _CopyToModel.apply(x, self)

    def model_local(self, x, k):
        return x  # one rank, k, reads it here

    def model_sum(self, parts):
        (p,) = parts
        return p if self.model == 1 else _ReduceFromModel.apply(p, self)

    def model_cat(self, parts, dim):
        (p,) = parts
        return p if self.model == 1 else _GatherFromModel.apply(p, self, dim,
                                                                 p.shape[dim] * self.model)

    def model_full(self, w, dim, n=None):
        return w if self.model == 1 else _GatherFromModel.apply(
            w, self, dim, w.shape[dim] * self.model if n is None else n)

    def model_cut(self, w, dim):
        return w if self.model == 1 else _CutToModel.apply(w, self, dim)

    def model_gather(self, parts, dim):
        (p,) = parts
        return p if self.model == 1 else _SeqEnter.apply(p, self, dim, p.shape[dim] * self.model)

    def model_columns(self, parts, dim, wants):
        (p,) = parts
        if self.model == 1:
            return super().model_columns(parts, dim, wants)
        return [_ModelColumns.apply(p, self, dim, wants)]

    def whole_rows(self, shape, dim):
        if self.model == 1 or dim is None or dim < 0:
            return None
        k, model = self.coords["model"], self.model
        whole = list(shape)
        whole[dim] *= model
        return tuple(whole), lambda t: t.chunk(model, dim)[k].contiguous()

    def seq_enter(self, x, dim, n):
        return x if self.model == 1 else _SeqEnter.apply(x, self, dim, n)

    def seq_reduce(self, parts, dim, n):
        (p,) = parts
        return p if self.model == 1 else _SeqReduce.apply(p, self, dim)

    def seq_scale(self, xhat, t, dim, n):
        return xhat * t if self.model == 1 else _SeqScale.apply(xhat, t, self, dim, n)

    def model_max(self, parts):
        import torch.distributed as dist

        (p,) = parts
        if self.model == 1:
            return p
        acc = p.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(acc, op=dist.ReduceOp.MAX, group=self._group(("model",)))
        return acc

    def leaf_row_sum(self, x, dim):
        s = x.reshape(x.shape[0], -1).sum(dim=1)
        if self.model == 1 or dim is None or dim < 0:
            return s
        return self._model_all_reduce(s)

    def _model_all_reduce(self, x):
        import torch.distributed as dist

        self.calls["model_psum"] += 1
        if self.model > 2 and dist.get_backend(self._group(("model",))) == "gloo":
            # gloo's ring adds each chunk in another order; the ranks' parts
            # gathered and added in rank order are bitwise the in-process sum
            rows = self._gather(x, ("model",))
            acc = rows[0]
            for row in rows[1:]:
                acc = acc + row
            return acc
        acc = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=self._group(("model",)))
        return acc


class _ReadInProcess(torch.autograd.Function):
    """Rank ``k``'s read of an entered activation in process: identity
    forward; backward the rank's gradient is added into its slot of
    ``reads`` and none goes on, so that :class:`_EnterInProcess` adds the
    ranks' in rank order."""

    @staticmethod
    def forward(ctx, x, reads, k):
        ctx.reads, ctx.k = reads, k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        got = ctx.reads[ctx.k]
        ctx.reads[ctx.k] = g if got is None else got + g
        return None, None, None


class _EnterInProcess(torch.autograd.Function):
    """Megatron's f in process: identity forward; backward the ranks'
    gradients summed in rank order, ((g0 + g1) + g2) + ..., the order of a
    process group's rank-ordered sum, whatever order autograd ran the
    ranks' reads in (plus a direct read's, if any)."""

    @staticmethod
    def forward(ctx, x, reads):
        ctx.set_materialize_grads(False)
        ctx.reads = reads
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        acc = g
        for k, t in enumerate(ctx.reads):
            if t is not None:
                acc = t if acc is None else acc + t
            ctx.reads[k] = None
        return acc, None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f over a process group's model axis: identity forward,
    the ranks' gradients psummed backward."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax._model_all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the ranks' partial results psummed forward, the
    gradient passed through (every rank reads the sum alike)."""

    @staticmethod
    def forward(ctx, x, ax):
        return ax._model_all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _own_rows(x: torch.Tensor, ax, dim: int) -> torch.Tensor:
    """The rank's chunk of ``x`` along ``dim``, padded with zeros to a
    multiple of the model size first (a rank's chunk is ceil(n / model)
    long; the last ranks' may be padding, as GSPMD pads an uneven split)."""
    n, model = x.shape[dim], ax.model
    c = -(-n // model)
    if c * model != n:
        pad = list(x.shape)
        pad[dim] = c * model - n
        x = torch.cat([x, x.new_zeros(pad)], dim)
    return x.narrow(dim, ax.coords["model"] * c, c).contiguous()


def _all_rows(x: torch.Tensor, ax, dim: int, n: int) -> torch.Tensor:
    """The ranks' chunks along ``dim`` all-gathered and concatenated in rank
    order, the padding past ``n`` cut off."""
    ax.calls["model_gather"] += 1
    rows = ax._gather(x, ("model",))
    return torch.cat(rows.unbind(0), dim).narrow(dim, 0, n)


class _GatherFromModel(torch.autograd.Function):
    """The ranks' pieces all-gathered along ``dim`` (the whole, ``n`` long)
    forward; backward the rank's chunk of the gradient of the whole (which
    every rank computes alike from the whole)."""

    @staticmethod
    def forward(ctx, x, ax, dim, n):
        ctx.ax, ctx.dim = ax, dim
        return _all_rows(x, ax, dim, n)

    @staticmethod
    def backward(ctx, g):
        return _own_rows(g, ctx.ax, ctx.dim), None, None, None


def _overlap(start: int, n: int, ranges) -> list:
    """The parts of ``ranges`` ((start, stop), ascending) inside [start,
    start + n), as (offset from ``start``, length) pairs."""
    out = []
    for a, b in ranges:
        lo, hi = max(a, start), min(b, start + n)
        if lo < hi:
            out.append((lo - start, hi - lo))
    return out


def _exchange(x: torch.Tensor, ax, dim: int, send, recv) -> torch.Tensor:
    """One all-to-all over the model subgroup: to rank j the pieces
    ``send[j]`` ((offset, length) along ``dim`` of ``x``) concatenated; from
    rank i ``recv[i]`` columns.  The pieces received, in source order,
    concatenated along ``dim``, contiguous (a strided view would send the
    computations that read it down other reduction orders than in
    process)."""
    import torch.distributed as dist

    ax.calls["model_all_to_all"] += 1
    xt = x.movedim(dim, 0)
    pieces = [xt.narrow(0, a, n) for per in send for a, n in per]
    out_t = torch.empty((sum(recv),) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out_t, torch.cat(pieces, 0) if pieces else xt.narrow(0, 0, 0),
                           output_split_sizes=list(recv),
                           input_split_sizes=[sum(n for _, n in per) for per in send],
                           group=ax._group(("model",)))
    return out_t.movedim(0, dim).contiguous()


class _ModelColumns(torch.autograd.Function):
    """:meth:`Collectives.model_columns` over a process group: each rank
    sends every other the columns of its chunk that rank wants (one
    all-to-all); backward the gradients of those columns go back (one
    all-to-all) and are added into the chunk's gradient in rank order."""

    @staticmethod
    def forward(ctx, x, ax, dim, wants):
        dim = dim % x.dim()
        c, k = x.shape[dim], ax.coords["model"]
        send = [_overlap(k * c, c, wants[j]) for j in range(ax.model)]
        recv = [sum(n for _, n in _overlap(i * c, c, wants[k])) for i in range(ax.model)]
        ctx.ax, ctx.dim, ctx.send, ctx.recv, ctx.shape = ax, dim, send, recv, x.shape
        return _exchange(x.contiguous(), ax, dim, send, recv)

    @staticmethod
    def backward(ctx, g):
        ax, dim, send = ctx.ax, ctx.dim, ctx.send
        back = [[(sum(ctx.recv[:i]), n)] if n else [] for i, n in enumerate(ctx.recv)]
        got = _exchange(g.contiguous(), ax, dim, back,
                        [sum(n for _, n in per) for per in send])
        out = g.new_zeros(ctx.shape)
        at = 0
        for per in send:  # rank order
            for a, n in per:
                out.narrow(dim, a, n).add_(got.narrow(dim, at, n))
                at += n
        return out, None, None, None


class _CutToModel(torch.autograd.Function):
    """The conjugate of :class:`_GatherFromModel`: a tensor every rank holds
    whole alike cut to the rank's chunk along ``dim`` forward; backward the
    ranks' chunks of the gradient all-gathered into the whole one."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.shape[dim]
        return _own_rows(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_rows(g.contiguous(), ctx.ax, ctx.dim, ctx.n), None, None


class _SeqEnter(torch.autograd.Function):
    """Megatron-SP's ``enter`` over a process group's model axis: the
    ranks' rows all-gathered forward; backward the ranks' gradients summed
    and the rank's rows kept (a reduce-scatter, built from an all-reduce
    and the rank's chunk: gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, ax, dim, n):
        ctx.ax, ctx.dim = ax, dim
        return _all_rows(x, ax, dim, n)

    @staticmethod
    def backward(ctx, g):
        return (_own_rows(ctx.ax._model_all_reduce(g), ctx.ax, ctx.dim), None, None,
                None)


class _SeqReduce(torch.autograd.Function):
    """Megatron-SP's ``reduce``: the ranks' partial results summed and the
    rank's rows kept forward (a reduce-scatter, from an all-reduce and the
    rank's chunk); backward the ranks' row gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim, ctx.n = ax, dim, x.shape[dim]
        return _own_rows(ax._model_all_reduce(x), ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_rows(g.contiguous(), ctx.ax, ctx.dim, ctx.n), None, None


class _SeqScale(torch.autograd.Function):
    """``xhat · t`` over the rank's rows of S; backward the rows' gradient
    ``g · t`` and the scale's that of the whole rows: the ranks' rows of
    ``g · xhat`` all-gathered and summed to t's shape in one reduction, as
    autograd sums them over the whole rows in one process (partial sums
    added over the ranks would round differently)."""

    @staticmethod
    def forward(ctx, xhat, t, ax, dim, n):
        ctx.save_for_backward(xhat, t)
        ctx.ax, ctx.dim, ctx.n = ax, dim, n
        return xhat * t

    @staticmethod
    def backward(ctx, g):
        xhat, t = ctx.saved_tensors
        ax, dim, n = ctx.ax, ctx.dim, ctx.n
        gt = g * xhat
        c = -(-n // ax.model)
        if gt.shape[dim] < c:  # the rank's rows end before its chunk does
            pad = list(gt.shape)
            pad[dim] = c - gt.shape[dim]
            gt = torch.cat([gt, gt.new_zeros(pad)], dim)
        whole = _all_rows(gt.contiguous(), ax, dim, n).contiguous()  # the layout summed in process
        return g * t, whole.sum_to_size(t.shape), None, None, None


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------


def _active(attack: Optional[AttackConfig]) -> bool:
    return attack is not None and attack.name != "none" and attack.alpha != 0.0


def _generator(key, device, *data) -> torch.Generator:
    return rng.generator(0 if key is None else key, *data, device=device)


@trace.spanned("attack")
def _maybe_attack(ax: Collectives, outer, rows: torch.Tensor, attack, m: int, key,
                  row_sum=None, model_dim=None):
    """Byzantine rows of the gathered ``rows`` (m, ...) replaced, on each
    worker of the axes ``outer`` the rows still vary over (every worker
    draws from the same key, as in the reference).  ``row_sum``: the
    leaf's per-row sums across its model shards, for leaf-global attacks;
    ``model_dim``: the leaf's split dim, over which a randomized payload
    is drawn whole and cut (:meth:`Collectives.whole_rows`)."""
    if not _active(attack):
        return rows
    mask = attack_engine.byzantine_mask(attack.alpha, m, device=rows.device)
    atk, _ = attack.resolve()

    def one(_w, r):
        gen = whole = None
        if atk.randomized:
            gen = _generator(key, r.device)
            if model_dim is not None and model_dim >= 0:
                whole = ax.whole_rows(tuple(r.shape), 1 + model_dim)
        return apply_gradient_attack(attack, r, mask, generator=gen, row_sum=row_sum,
                                     whole=whole)

    if not outer:
        return one(0, rows)
    return ax.map_workers(one, outer, rows, out=torch.empty_like(rows))


def _aggregate_rows(ax: Collectives, outer, rows, method: str, beta: float):
    """Aggregate each of ``rows`` ((m, ...) per worker of ``outer``) over
    its m rows, all of them in one :func:`aggregators.aggregate_leaves`
    call: one kernel launch for up to 16 same-dtype leaves on the card."""
    k = len(ax.vshape(outer)) if outer else 0
    return aggregators.aggregate_leaves([r.movedim(k, 0) for r in rows], method, beta)


# --------------------------------------------------------------------------
# gather strategy (paper-faithful Algorithm 1 aggregation)
# --------------------------------------------------------------------------


def _leaf_dims(model_dims, n: int) -> list:
    """Each of n leaves' split dim (None without a model axis)."""
    return [None] * n if model_dims is None else list(model_dims)


def _row_sums(ax: Collectives, model_dims, n: int) -> list:
    """Per leaf, the ``row_sum`` of a leaf-global attack: the leaf's per-row
    sums across its model shards (``model_dims[i]`` its split dim, -1
    whole), or None without a model axis."""
    if model_dims is None or ax.model == 1:
        return [None] * n
    return [None if d < 0 else (lambda x, d=d: ax.leaf_row_sum(x, d)) for d in model_dims]


def robust_gather_agg(g, ax: Collectives, axis_names: Sequence[str], method: str = "median",
                      beta: float = 0.1, attack: Optional[AttackConfig] = None,
                      agg_dtype=None, attack_key=None, model_dims=None):
    """All-gather per-worker gradients over ``axis_names`` and aggregate.

    ``g``: tree of varying gradient leaves.  Returns the aggregated tree,
    replicated over ``axis_names``.  ``attack_key`` seeds randomized
    attacks (fold the step index in per training step).  Under a model
    axis ``model_dims`` (each leaf's split dim in :func:`tree_leaves`
    order, -1 whole) completes a leaf-global attack's sums over the
    leaf's shards, as GSPMD's psum over the model axis does, and a
    randomized attack draws each leaf's payload whole."""
    names = tuple(axis_names)
    m = ax.size(names)
    outer = ax.outer(names)
    leaves = tree_leaves(g)
    rows = []
    for leaf, row_sum, d in zip(leaves, _row_sums(ax, model_dims, len(leaves)),
                                _leaf_dims(model_dims, len(leaves))):
        stacked = ax.all_gather(leaf, names)
        if agg_dtype is not None:
            stacked = stacked.to(agg_dtype)
        rows.append(_maybe_attack(ax, outer, stacked, attack, m, attack_key, row_sum, d))
    outs = _aggregate_rows(ax, outer, rows, method, beta)
    return tree_unflatten_like(g, [o.to(leaf.dtype) for o, leaf in zip(outs, leaves)])


# --------------------------------------------------------------------------
# bucketed strategy (robust "all-reduce" via all_to_all)
# --------------------------------------------------------------------------


def _flat(ax: Collectives, names, x: torch.Tensor) -> torch.Tensor:
    """A varying value raveled per worker."""
    return x.reshape(ax.vshape(names) + (-1,))


def _scatter_rows(ax: Collectives, flat: torch.Tensor, names) -> Tuple[torch.Tensor, int]:
    """The all_to_all half of the bucketed strategies: local flat (G,) ->
    (m, bs) rows, row i worker i's copy of this worker's bucket
    (coordinates [j*bs, (j+1)*bs) for worker j), and G."""
    m = ax.size(names)
    size = flat.shape[-1]
    bs = -(-size // m)
    if bs * m - size:
        flat = F.pad(flat, (0, bs * m - size))
    # bucket (i_0, .., i_{k-1}) goes to the worker at that mesh coordinate
    rows = flat.reshape(ax.vshape(names) + tuple(ax.size((a,)) for a in names) + (bs,))
    for dim, a in enumerate(names):
        rows = ax.all_to_all(rows, a, dim, names)
    return rows.reshape(ax.vshape(names) + (m, bs)), size


def _robust_scatter_flat(ax: Collectives, flat: torch.Tensor, axis_names, method: str,
                         beta: float, attack, agg_dtype, attack_key=None):
    """Core of the bucketed strategies: local flat gradient (G,) -> this
    worker's aggregated bucket (ceil(G/m),), and G."""
    names = tuple(axis_names)
    rows, size = _scatter_rows(ax, flat, names)
    if agg_dtype is not None:
        rows = rows.to(agg_dtype)
    rows = _maybe_attack(ax, names, rows, attack, ax.size(names), attack_key)
    return _aggregate_rows(ax, names, [rows], method, beta)[0].to(flat.dtype), size


#: element cap per coalesced super-bucket (16 MiB in f32)
_COALESCE_MAX_ELEMS = 1 << 22


def _coalesce_groups(leaves, max_elems: int = _COALESCE_MAX_ELEMS):
    """Group leaf indices into size-binned super-buckets: binned by (dtype,
    bit length of the size), packed greedily within a bin into groups of at
    most ``max_elems`` elements (always >= 1 leaf).  ``leaves`` are one
    worker's tensors (or anything with ``numel()`` and ``dtype``);
    deterministic in leaf order."""
    bins: Dict[tuple, list] = {}
    for idx, leaf in enumerate(leaves):
        key = (str(leaf.dtype), max(int(leaf.numel()), 1).bit_length())
        bins.setdefault(key, []).append(idx)
    groups = []
    for key in sorted(bins):
        cur, cur_elems = [], 0
        for idx in bins[key]:
            if cur and cur_elems + leaves[idx].numel() > max_elems:
                groups.append(cur)
                cur, cur_elems = [], 0
            cur.append(idx)
            cur_elems += leaves[idx].numel()
        groups.append(cur)
    return groups


def robust_bucketed_agg(g, ax: Collectives, axis_names: Sequence[str], method: str = "median",
                        beta: float = 0.1, attack: Optional[AttackConfig] = None,
                        agg_dtype=None, granularity: str = "leaf", attack_key=None):
    """Exact robust aggregation with all-reduce-like byte volume: per
    super-bucket (``granularity='leaf'``, :func:`_coalesce_groups`) or for
    the flat concat of every leaf (``'flat'``), all_to_all the buckets,
    aggregate your own bucket, all_gather.  Returns the aggregated tree,
    replicated.  Every group's buckets take one aggregation call between
    them (exact: the aggregators are coordinate-wise)."""
    names = tuple(axis_names)
    m = ax.size(names)
    k = len(ax.vshape(names))
    leaves = tree_leaves(g)
    if granularity == "leaf":
        one = [leaf[(0,) * k] for leaf in leaves]  # one worker's leaves
        groups = _coalesce_groups(one)
    elif granularity == "flat":
        groups = [list(range(len(leaves)))]
    else:
        raise ValueError(f"granularity must be 'leaf' or 'flat', got {granularity!r}")
    flats, rows = [], []
    for grp in groups:
        flat = torch.cat([_flat(ax, names, leaves[i]) for i in grp], dim=-1) \
            if len(grp) > 1 else _flat(ax, names, leaves[grp[0]])
        r, size = _scatter_rows(ax, flat, names)
        if agg_dtype is not None:
            r = r.to(agg_dtype)
        rows.append(_maybe_attack(ax, names, r, attack, m, attack_key))
        flats.append((flat.dtype, size))
    mines = _aggregate_rows(ax, names, rows, method, beta)
    del rows
    out = [None] * len(leaves)
    for grp, mine, (dtype, size) in zip(groups, mines, flats):
        full = ax.all_gather(mine.to(dtype), names, tiled=True)[:size]
        off = 0
        for i in grp:
            local = leaves[i].shape[k:]
            n = math.prod(local)
            out[i] = full[off:off + n].reshape(local).to(leaves[i].dtype)
            off += n
    return tree_unflatten_like(g, out)


def robust_reduce_scatter(flat: torch.Tensor, ax: Collectives, axis_names: Sequence[str],
                          method: str = "median", beta: float = 0.1,
                          attack: Optional[AttackConfig] = None, agg_dtype=None):
    """Robust replacement for ``psum_scatter`` on a flat vector: only this
    worker's aggregated bucket (padded bucket size), varying."""
    return _robust_scatter_flat(ax, flat, axis_names, method, beta, attack, agg_dtype)[0]


def robust_reduce_scatter_dims(cts: Sequence[torch.Tensor], dims: Sequence[int],
                               ax: Collectives, axis_names: Sequence[str],
                               method: str = "median", beta: float = 0.1,
                               attack: Optional[AttackConfig] = None) -> list:
    """The robust parameter gather's backward for each varying full-size
    cotangent ``cts[i]`` along ``dims[i]``: the dim moved to the front, the
    cotangent raveled and :func:`robust_reduce_scatter`-ed, so that every
    worker gets its own shard (chunk ``w`` along the dim, varying) of the
    robust aggregate of the m workers' cotangents.  Each cotangent is its
    own bucket (the attack sees it alone); the buckets of all of them take
    ONE aggregation call (one B1 / B2 launch for up to MAX_LEAVES leaves of
    a dtype on the card).  The attack runs with no key, as the
    reference's."""
    names = tuple(axis_names)
    m = ax.size(names)
    vs = ax.vshape(names)
    k = len(vs)
    rows, shapes = [], []
    for ct, dim in zip(cts, dims):
        moved = ct.movedim(k + dim, k)
        if moved.shape[k] % m:
            raise ValueError(f"dim {dim} of size {moved.shape[k]} does not split over {m} "
                             "workers")
        r, _ = _scatter_rows(ax, _flat(ax, names, moved), names)
        rows.append(_maybe_attack(ax, names, r, attack, m, None))
        shapes.append((moved.shape[k] // m,) + tuple(moved.shape[k + 1:]))
    mines = _aggregate_rows(ax, names, rows, method, beta)
    del rows
    return [mine.to(ct.dtype).reshape(vs + shape).movedim(k, k + dim)
            for mine, shape, ct, dim in zip(mines, shapes, cts, dims)]


class _RobustParamGather(torch.autograd.Function):
    """Forward: every worker's shard all-gathered along ``dim`` (each
    worker its own copy of the full tensor, varying, so that the
    cotangents come back per worker), laid out contiguously as the full
    parameter is (a transposed view would send the matmuls that read it
    down another cuBLAS path, which rounds differently).  Backward:
    :func:`robust_reduce_scatter_dims`, the shard of the robust aggregate
    in place of the summed cotangent."""

    @staticmethod
    def forward(ctx, shard, ax, names, dim, method, beta, attack):
        ctx.args = (ax, names, dim, method, beta, attack)
        vo = len(ax.vshape(ax.outer(names)))
        vn = ax.vshape(names)
        front = vo + len(vn)
        full = ax.all_gather(shard.movedim(front + dim, front), names, tiled=True)
        full = full.movedim(vo, vo + dim).contiguous()
        lead, local = full.shape[:vo], full.shape[vo:]
        return full.reshape(lead + (1,) * len(vn) + local).expand(lead + vn + local)

    @staticmethod
    def backward(ctx, ct):
        ax, names, dim, method, beta, attack = ctx.args
        (shard,) = robust_reduce_scatter_dims([ct], [dim], ax, names, method, beta, attack)
        return shard, None, None, None, None, None, None


def make_robust_param_gather_dim(ax: Collectives, axis_names: Sequence[str], dim: int,
                                 method: str = "median", beta: float = 0.1,
                                 attack: Optional[AttackConfig] = None) -> Callable:
    """``gather(w_shard) -> w_full`` along tensor dim ``dim`` (the leaf's
    FSDP dim) over ``axis_names``, whose backward is the robust
    reduce-scatter in place of ``psum_scatter``: each worker's shard
    gradient is its chunk of the exact coordinate-wise median / trimmed
    mean of the m per-worker gradients of the full tensor."""
    names = tuple(axis_names)
    return lambda w: _RobustParamGather.apply(w, ax, names, dim, method, beta, attack)


def make_robust_param_gather(ax: Collectives, axis_names: Sequence[str],
                             method: str = "median", beta: float = 0.1,
                             attack: Optional[AttackConfig] = None) -> Callable:
    """:func:`make_robust_param_gather_dim` along dim 0."""
    return make_robust_param_gather_dim(ax, axis_names, 0, method, beta, attack)


# --------------------------------------------------------------------------
# chunked strategy (approximate: histogram sketch via psum, O(1) in m)
# --------------------------------------------------------------------------


def _flat_whole(ax: Collectives, shape, dim):
    """:meth:`Collectives.whole_rows` of a leaf of (this process's) ``shape``
    raveled: (the whole leaf's ravel shape, the cut of this process's
    ravel from the whole ravel), or None."""
    spec = None if dim is None else ax.whole_rows(tuple(shape), dim)
    if spec is None:
        return None
    whole, cut = spec
    return (math.prod(whole),), lambda t: cut(t.reshape(whole)).reshape(-1)


def _maybe_attack_chunked(ax: Collectives, flat: torch.Tensor, attack, axis_names, m: int,
                          key=None, whole=None) -> torch.Tensor:
    """Byzantine simulation without gathered rows: a worker's local flat
    gradient is replaced iff its index is under the attack's Byzantine
    cut.  Stats-level colluders get the honest mean (and variance) psummed
    over the honest workers; local attacks use the worker's own row and a
    worker-folded key (a randomized payload drawn over the whole leaf where
    ``whole``, :func:`_flat_whole`, says the row is a model shard of it);
    omniscient attacks cannot run here and raise."""
    if not _active(attack) or attack.is_data_attack():
        return flat
    q = attack.num_byzantine(m)
    if q == 0:
        return flat
    names = tuple(axis_names)
    is_byz = (ax.index(names) < q)[..., None]
    atk = attack.resolve()[0]
    honest_mean = honest_var = None
    if attack_base.access_rank(atk.access) >= attack_base.access_rank(attack_base.STATS):
        honest_mean = ax.psum(torch.where(is_byz, 0.0, flat), names) / (m - q)
        if atk.needs_variance:
            dev = torch.where(is_byz, 0.0, (flat - honest_mean) ** 2)
            honest_var = ax.psum(dev, names) / (m - q)

    def payload(w, own):
        gen = _generator(key, own.device, w) if atk.randomized else None
        return byzantine_payload(attack, honest_mean, honest_var, m=m, own=own,
                                 generator=gen, whole=whole if gen is not None else None
                                 ).to(own.dtype)

    bad = ax.map_workers(payload, names, flat, out=torch.empty_like(flat))
    return torch.where(is_byz, bad, flat)


def robust_chunked_agg(g, ax: Collectives, axis_names: Sequence[str], method: str = "median",
                       beta: float = 0.1, attack: Optional[AttackConfig] = None,
                       agg_dtype=None, nbins: int = 256, coord_chunk: int = COORD_CHUNK,
                       attack_key=None, model_dims=None):
    """Approximate robust aggregation with m-independent collective volume.

    Per leaf: (1) the per-coordinate range by pmin / pmax; (2) the psum of
    every worker's one-hot counts (and sums, for the trimmed mean) of its
    row, ``coord_chunk`` coordinates at a time, one collective a chunk;
    (3) the CDF inverted locally, so every worker holds the same result.
    ``method``: ``median`` | ``trimmed_mean`` (error <= one bin width
    (max - min)/nbins per coordinate) | ``mean`` (exact: one psum).
    ``model_dims`` (each leaf's split dim) sizes a randomized payload's
    draw over the whole leaf under a model axis."""
    method = {"approx_median": "median",
              "approx_trimmed_mean": "trimmed_mean"}.get(method, method)
    names = tuple(axis_names)
    m = ax.size(names)
    k = len(ax.vshape(names))

    def agg_leaf(leaf, d):
        local = leaf.shape[k:]
        flat = _flat(ax, names, leaf)
        if agg_dtype is not None:
            flat = flat.to(agg_dtype)
        flat = _maybe_attack_chunked(ax, flat.float(), attack, names, m, attack_key,
                                     _flat_whole(ax, local, d))
        if method == "mean":
            return (ax.psum(flat, names) / m).reshape(local).to(leaf.dtype)
        if method not in ("median", "trimmed_mean"):
            raise ValueError(
                f"chunked strategy supports mean|median|trimmed_mean, got {method!r}")
        with_sums = method == "trimmed_mean"
        lo, width = H.edges(*ax.pminmax(flat, names), nbins)
        outs = []
        for a in range(0, flat.shape[-1], coord_chunk):
            seg = flat[..., a:a + coord_chunk]
            slo, sw = lo[a:a + coord_chunk], width[a:a + coord_chunk]
            counts, sums = ax.psum_histogram(seg, slo, sw, nbins, with_sums, names)
            if method == "median":
                outs.append(H.median_from_hist(counts, slo, sw, m))
            else:
                outs.append(H.trimmed_mean_from_hist(counts, sums, slo, sw, m, beta))
        return torch.cat(outs).reshape(local).to(leaf.dtype)

    leaves = tree_leaves(g)
    return tree_unflatten_like(g, [agg_leaf(x, d) for x, d in
                                   zip(leaves, _leaf_dims(model_dims, len(leaves)))])


# --------------------------------------------------------------------------
# psum strategy (plain data-parallel all-reduce mean — no robustness)
# --------------------------------------------------------------------------


def robust_psum_agg(g, ax: Collectives, axis_names: Sequence[str], method: str = "mean",
                    beta: float = 0.1, attack: Optional[AttackConfig] = None,
                    agg_dtype=None, attack_key=None, model_dims=None):
    """Plain data-parallel mean: one psum per leaf, NO robustness — the
    throughput baseline.  Rejects any ``method`` but ``mean`` (a psum cannot
    compute order statistics).  Attacks are simulated row-free as in the
    chunked strategy (``model_dims`` as there)."""
    names = tuple(axis_names)
    if method != "mean":
        raise ValueError(
            f"psum strategy is the plain data-parallel mean baseline; it "
            f"cannot compute {method!r} (use gather/bucketed/chunked)")
    m = ax.size(names)
    k = len(ax.vshape(names))

    def agg_leaf(leaf, d):
        flat = _flat(ax, names, leaf)
        if agg_dtype is not None:
            flat = flat.to(agg_dtype)
        flat = _maybe_attack_chunked(ax, flat.float(), attack, names, m, attack_key,
                                     _flat_whole(ax, leaf.shape[k:], d))
        return (ax.psum(flat, names) / m).reshape(leaf.shape[k:]).to(leaf.dtype)

    leaves = tree_leaves(g)
    return tree_unflatten_like(g, [agg_leaf(x, d) for x, d in
                                   zip(leaves, _leaf_dims(model_dims, len(leaves)))])


# --------------------------------------------------------------------------
# hierarchical strategy (approximate: median-of-medians across pods)
# --------------------------------------------------------------------------


def robust_hierarchical_agg(g, ax: Collectives, inner_axis: str, outer_axis: str,
                            method: str = "median", beta: float = 0.1,
                            attack: Optional[AttackConfig] = None, attack_key=None,
                            model_dims=None):
    """Two-level aggregation: within ``inner_axis``, then across
    ``outer_axis``.  Median-of-medians is a different estimator from the
    global median (DESIGN.md)."""
    inner = robust_gather_agg(g, ax, (inner_axis,), method, beta, attack,
                              attack_key=attack_key, model_dims=model_dims)
    return robust_gather_agg(inner, ax, (outer_axis,), method, beta, attack=None)
