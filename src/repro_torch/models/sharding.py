"""Partition rules for parameter leaves (the reference's
``repro.models.sharding``).

A spec is a tuple with one entry per dim: an axis name (or a tuple of
them) where the dim is split over that mesh axis, ``None`` where it is
whole; the reference's ``PartitionSpec`` as a plain tuple.  The rules
are pure functions of a leaf's path and shape, so they need no mesh.

The model-parallel ("megatron") rules mark one dim of each weight with
the ``model`` axis.  Nothing in the port splits a tensor over ``model``
yet: the FSDP dims (:func:`repro_torch.launch.steps.fsdp_dims`) read
these specs to stay off the model dim, as the reference's do, and that
reading matters at model size 1 too, where every leaf with a rule gets
``model`` on its first preferred dim (every size divides by 1).

The reference's ``ShardCtx`` (activation constraints over the model axis)
is not here: it acts only when the model axis is larger than 1, which is
tensor parallelism, a later slice (ROADMAP queue A item 6, step 4).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.tree import tree_map_with_path

Spec = Tuple[Optional[str], ...]

# candidate dims in preference order; the first one divisible by the
# model-axis size wins (grok's 8 experts cannot split 16 ways, so its
# expert FFNs fall back to F)
RULES = {
    "embed": [0, 1],  # (V, D) -> vocab, else d_model
    "lm_head": [1, 0],  # (D, V)
    "wq": [-1], "wk": [-1], "wv": [-1],  # (.., D, H*hd) -> head product
    "wo": [-2],  # (.., H*hd, D)
    "wg": [-1], "wu": [-1],  # (.., D, F)
    "wd": [-2],  # (.., F, D)
    "we_g": [-3, -1], "we_u": [-3, -1],  # (.., E, D, F) -> experts, else F
    "we_d": [-3, -2],  # (.., E, F, D)
    "router": [-1, -2],  # (.., D, E)
    "w_in": [-1],  # ssm in-proj packed
    "w_out": [-2],
    "w_bx": [-1], "w_bg": [-1],  # rec branch projections (.., D, C)
    "w_ro": [-2],  # rec out  (.., C, D)
    "w_a": [-1], "w_xg": [-1],  # rglru square mats
}


def param_partition_spec(path: str, shape: Tuple[int, ...], model_axis: str = "model",
                         mesh_model: int = 16) -> Spec:
    """The model-axis spec of the leaf at ``path`` (keys joined by ``/``;
    the rule is keyed on the last one): the first preferred dim whose
    size is at least ``mesh_model`` and divisible by it, else replicated."""
    spec = [None] * len(shape)
    for dim in RULES.get(path.split("/")[-1], []):
        d = dim % len(shape)
        if shape[d] % mesh_model == 0 and shape[d] >= mesh_model:
            spec[d] = model_axis
            break
    return tuple(spec)


def tree_partition_specs(params, model_axis: str = "model", mesh_model: int = 16):
    """A spec for every leaf of ``params`` (tensors, meta tensors included)."""
    return tree_map_with_path(
        lambda path, leaf: param_partition_spec(path, tuple(leaf.shape), model_axis,
                                                mesh_model), params)
