"""Attack-engine core types: access levels, attack context, attack spec.

Every attack declares how much of the honest gradients it may observe:

``feedback``    corrupts a Byzantine user's feedback scores (serving
                traffic); no gradient-space payload.
``data``        corrupts the Byzantine worker's local samples before the
                gradient is computed (the paper's label-flip experiments).
``local``       sees only the Byzantine worker's own gradient (plus the
                public previous aggregate).
``stats``       colluders also observe the coordinate-wise mean and
                variance of the honest gradients (the ALIE oracle).
``omniscient``  sees every honest gradient row.

The context handed to a payload exposes ONLY the fields its access level
grants (lower levels see ``None``), so the contract is structural.
Randomized attacks draw from ``ctx.generator``, a ``torch.Generator``
seeded per (base seed, round) by the caller.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

FEEDBACK = "feedback"
DATA = "data"
LOCAL = "local"
STATS = "stats"
OMNISCIENT = "omniscient"
ACCESS_LEVELS = (FEEDBACK, DATA, LOCAL, STATS, OMNISCIENT)

# Arrival-timing behaviours an attack may declare for buffered async
# rounds; synchronous engines ignore the declaration.
ARRIVAL_BEHAVIOURS = ("first", "last", "greedy")


def access_rank(access: str) -> int:
    if access not in ACCESS_LEVELS:
        raise ValueError(f"unknown access level {access!r}; want one of {ACCESS_LEVELS}")
    return ACCESS_LEVELS.index(access)


@dataclasses.dataclass
class AttackContext:
    """Everything a gradient-space attack may observe, pre-filtered by access.

    ``rows``/``own`` carry the leading worker axis ``(m, ...)`` on the
    gathered-rows path; on the statistics path ``own`` is one worker's row
    ``(...)`` and ``rows`` is ``None``.  ``honest_mean``/``honest_var`` and
    ``prev_agg`` are row-broadcastable ``(...)``; ``agg_history`` stacks
    past aggregates newest first and ``staleness`` indexes it (1 = the
    previous round's aggregate).
    """

    m: int
    alpha: object  # Byzantine fraction (float or tensor)
    strength: object  # attack-strength knob (float or tensor)
    prev_agg: Optional[torch.Tensor] = None
    agg_history: Optional[torch.Tensor] = None
    staleness: object = None
    round: object = None
    generator: Optional[torch.Generator] = None  # randomized attacks
    own: Optional[torch.Tensor] = None  # local and above
    honest_mean: Optional[torch.Tensor] = None  # stats and above
    honest_var: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None  # omniscient only
    mask: Optional[torch.Tensor] = None  # (m,) bool, True = Byzantine
    # each row's sum of a per-coordinate (m, ...) tensor over the whole
    # leaf, its other model shards included (tensor parallelism); None:
    # the rows hold the whole leaf
    row_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    # (the whole leaf's shape, a function cutting this process's part from a
    # tensor of that shape) where ``own`` holds a model shard of the leaf:
    # a randomized payload draws the whole and cuts, so that its bits are
    # the whole leaf's at any model size; None: ``own`` is the whole leaf
    whole: Optional[Tuple[tuple, Callable[[torch.Tensor], torch.Tensor]]] = None


PayloadFn = Callable[[AttackContext], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Attack:
    """A registered attack: payload formula + declared capabilities.

    ``payload(ctx)`` returns the Byzantine rows, row-broadcastable ``(...)``
    or per-row ``(m, ...)``.  Data attacks implement
    ``corrupt_labels(labels, generator, num_classes)``; feedback attacks
    ``corrupt_feedback(scores, generator, strength)``.
    """

    name: str
    access: str
    payload: Optional[PayloadFn] = None
    strength: float = 1.0
    adaptive: bool = False
    randomized: bool = False
    needs_variance: bool = False  # payload reads ctx.honest_var
    reads_own: bool = False  # payload reads ctx.own's VALUES (not just shape)
    # the payload at a coordinate reads the rows' other coordinates (a sum
    # over the leaf): under a model axis it needs ctx.row_sum, and the
    # bucketed strategies (buckets of a rank's own ravel) cannot run it
    leaf_global: bool = False
    arrival: Optional[str] = None
    summary: str = ""
    corrupt_labels: Optional[Callable] = None
    corrupt_feedback: Optional[Callable] = None

    def __post_init__(self):
        access_rank(self.access)  # validate
        if self.arrival is not None and self.arrival not in ARRIVAL_BEHAVIOURS:
            raise ValueError(
                f"attack {self.name!r}: unknown arrival behaviour "
                f"{self.arrival!r}; want one of {ARRIVAL_BEHAVIOURS} or None")
        if self.access == FEEDBACK:
            if self.corrupt_feedback is None:
                raise ValueError(
                    f"feedback attack {self.name!r} needs corrupt_feedback")
        elif self.access == DATA:
            if self.corrupt_labels is None:
                raise ValueError(f"data attack {self.name!r} needs corrupt_labels")
        elif self.payload is None:
            raise ValueError(f"gradient attack {self.name!r} needs a payload fn")
