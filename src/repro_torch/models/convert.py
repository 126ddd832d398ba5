"""Weight and state carrier between the reference's numpy trees and the
port's tensors.

The port keeps the reference's parameter layout (HWIO conv weights,
``fc1`` rows in HWC-flatten order), so conversion checks keys, shapes
and dtypes and moves tensors; it never reshapes.  ``linreg`` parameters
are a bare (d,) vector in both packages.  :func:`round_state_from_reference`
carries a round engine state (iterate, previous aggregate, optimizer
slots, error-feedback residual, round) across.  :func:`transformer_from_reference` /
:func:`transformer_to_reference` carry the transformer's tree
(``blocks`` stacked, the ``tail`` a list), bfloat16 leaves and float32
leaves of bfloat16 models included, with every dict's keys in sorted
order: the order ``jax.flatten_util.ravel_pytree`` ravels in, which the
port's :func:`repro_torch.tree.ravel` (insertion order) then follows.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve

_KEYS = {
    "logreg": ("w", "b"),
    "cnn": ("c1", "b1", "c2", "b2", "fc1", "bf1", "fc2", "bf2"),
}


def _expected_shapes(name: str, p: Dict[str, np.ndarray]) -> Dict[str, Tuple[int, ...]]:
    """The shapes the model's layout implies, from its free dimensions."""
    if name == "logreg":
        d, c = p["w"].shape
        return {"w": (d, c), "b": (c,)}
    width = p["c1"].shape[-1]
    hidden, classes = p["fc2"].shape
    return {"c1": (3, 3, 1, width), "b1": (width,), "c2": (3, 3, width, width),
            "b2": (width,), "fc1": (7 * 7 * width, hidden), "bf1": (hidden,),
            "fc2": (hidden, classes), "bf2": (classes,)}


def _tensor(name: str, a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"{name}: expected float32, got {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(device)  # a copy: never aliased


def from_reference(name: str, params_np, device="cuda"
                   ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's parameters (numpy arrays) as the port's tensors."""
    dev = resolve(device)
    if name == "linreg":
        if np.ndim(params_np) != 1:
            raise ValueError(f"linreg: expected a (d,) vector, got shape {np.shape(params_np)}")
        return _tensor("linreg", params_np, dev)
    if name not in _KEYS:
        raise ValueError(f"unknown model {name!r}; want logreg, cnn or linreg")
    if set(params_np) != set(_KEYS[name]):
        raise KeyError(f"{name}: expected keys {sorted(_KEYS[name])}, got {sorted(params_np)}")
    for k in ("w", "c1", "fc2"):
        if k in params_np and np.ndim(params_np[k]) != (4 if k == "c1" else 2):
            raise ValueError(f"{name}: {k} has shape {np.shape(params_np[k])}")
    want = _expected_shapes(name, params_np)
    for k in _KEYS[name]:
        if tuple(np.shape(params_np[k])) != want[k]:
            raise ValueError(f"{name}: {k} has shape {np.shape(params_np[k])}, "
                             f"expected {want[k]}")
    return {k: _tensor(f"{name}.{k}", params_np[k], dev) for k in _KEYS[name]}


def to_reference(params) -> Union[np.ndarray, Dict[str, np.ndarray]]:
    """The port's parameters as numpy arrays in the reference's layout."""
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _opt_state(opt_state, device: torch.device):
    """The reference's optimizer state: ``()`` (sgd), one slot (momentum)
    or ``{"m", "v"}`` (AdamW); every slot float32."""
    if isinstance(opt_state, (tuple, list)) and len(opt_state) == 0:
        return ()
    if isinstance(opt_state, dict):
        if set(opt_state) != {"m", "v"}:
            raise KeyError(f"optimizer state: expected keys ['m', 'v'], got {sorted(opt_state)}")
        return {k: _tensor(f"opt_state.{k}", opt_state[k], device) for k in ("m", "v")}
    return _tensor("opt_state", opt_state, device)


def round_state_from_reference(state_np: dict, *, seed: int = 0, device="cuda") -> dict:
    """The reference's round engine state (a dict of numpy leaves: ``w``,
    ``prev_agg``, ``opt_state``, ``round``, and ``comp_res``/``key``) as
    the port's :data:`~repro_torch.rounds.engine.RoundState`.

    The reference's threefry ``key`` has no counterpart (the port derives
    its draws from an integer seed), so the port's ``seed`` is given here.
    ``comp_res``, an error-feedback codec's per-client residual (a float32
    (num_clients, d) array: each client's row, :func:`repro_torch.fed.
    rounds.init_comp_residual`'s layout), is carried as it is; ``()`` (a
    stateless codec) stays ``()``.
    """
    from repro_torch.rounds import engine

    dev = resolve(device)
    w = _tensor("w", state_np["w"], dev)
    prev = _tensor("prev_agg", state_np["prev_agg"], dev)
    if prev.shape != w.shape:
        raise ValueError(f"prev_agg has shape {tuple(prev.shape)}, w {tuple(w.shape)}")
    comp_res = state_np.get("comp_res", ())
    if isinstance(comp_res, (tuple, list)) and len(comp_res) == 0:
        comp_res = ()
    else:
        comp_res = _tensor("comp_res", comp_res, dev)
        if comp_res.dim() != 2 or comp_res.shape[1:] != w.shape:
            raise ValueError(f"comp_res has shape {tuple(comp_res.shape)}: expected a row of "
                             f"w's shape {tuple(w.shape)} per client")
    return engine.make_state(w, prev_agg=prev, comp_res=comp_res,
                             opt_state=_opt_state(state_np["opt_state"], dev),
                             seed=seed, rnd=int(np.asarray(state_np["round"])))


# ------------------------------------------------------- the transformer


def _leaf_from_numpy(path: str, a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if dtype == torch.bfloat16:
        if a.dtype.name != "bfloat16":
            raise TypeError(f"{path}: expected bfloat16, got {a.dtype}")
        bits = np.array(a.view(np.uint16), order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    want = str(dtype).removeprefix("torch.")
    if a.dtype.name != want:
        raise TypeError(f"{path}: expected {want}, got {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(device)


def transformer_from_reference(cfg, params_np, device="cuda") -> dict:
    """The reference's transformer parameters (a tree of numpy arrays,
    ``blocks`` stacked ``(n_super, ...)``, ``tail`` a list) as the port's tensors: keys,
    shapes and dtypes checked against ``transformer.param_shapes(cfg)``,
    every dict rebuilt with sorted keys."""
    from repro_torch.models import transformer as T

    dev = resolve(device)

    def build(path, spec, tree):
        if isinstance(spec, dict):
            if not isinstance(tree, dict) or set(tree) != set(spec):
                got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
                raise KeyError(f"{path or 'params'}: expected keys {sorted(spec)}, got {got}")
            return {k: build(f"{path}/{k}" if path else k, spec[k], tree[k])
                    for k in sorted(spec)}
        if isinstance(spec, list):  # the unrolled tail
            if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
                raise KeyError(f"{path}: expected a list of {len(spec)} layers, got "
                               f"{type(tree).__name__}")
            return [build(f"{path}/{i}", sp, t) for i, (sp, t) in enumerate(zip(spec, tree))]
        shape, dtype = spec
        if tuple(np.shape(tree)) != tuple(shape):
            raise ValueError(f"{path}: shape {np.shape(tree)}, expected {tuple(shape)}")
        return _leaf_from_numpy(path, tree, dtype, dev)

    return build("", T.param_shapes(cfg), params_np)


def transformer_to_reference(params) -> dict:
    """The port's transformer parameters as numpy arrays (bfloat16 leaves as
    ``ml_dtypes.bfloat16``, numpy's extension type that JAX uses)."""
    def leaf(t: torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
        return t.numpy()

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return leaf(tree)

    return walk(params)
