"""Cell drivers, one module a kind of traffic (a traffic file's ``kind``):
``run(cell, seed, seconds, trace, device, t_start)`` returns the parts of
the result line.  What the drivers share: :func:`port_config`."""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict

from chipbench.bench import CellError


def _build(cls: type, values: Dict[str, Any]):
    """The dataclass ``cls`` of ``values``: a nested dict becomes its
    field's dataclass, a list a tuple where the field is a tuple; a key
    that is not a field raises."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - fields)
    if unknown:
        raise CellError(f"{cls.__name__} has no field {', '.join(unknown)}")
    hints = typing.get_type_hints(cls)
    kw = {}
    for k, v in values.items():
        hint = hints[k]
        if isinstance(v, dict):
            inner = [t for t in typing.get_args(hint) + (hint,) if dataclasses.is_dataclass(t)]
            if not inner:
                raise CellError(f"{cls.__name__}.{k} takes no group of keys")
            v = _build(inner[0], v)
        elif isinstance(v, list) and typing.get_origin(hint) is tuple:
            v = tuple(v)
        kw[k] = v
    return cls(**kw)


def port_config(port: Dict[str, Any]):
    """The port's ``ModelConfig`` of a configuration file's ``port`` group
    (``moe`` and ``ssm`` as their dataclasses, ``hybrid_pattern`` a tuple)."""
    from repro_torch.configs.base import ModelConfig

    return _build(ModelConfig, port)
