"""repro_torch.attacks — registry-based Byzantine attack engine.

- ``base``      access levels, :class:`AttackContext`, :class:`Attack`;
- ``registry``  name -> Attack registration and lookup;
- ``library``   the registered attacks;
- ``engine``    applying attacks on the gathered-rows and statistics paths;
- ``schedule``  the greedy adaptive attack and arrival-timing schedulers;
- ``matrix``    the robustness scenario matrix and its CI gate
  (``python -m repro_torch.attacks.matrix``).
"""
from repro_torch.attacks.base import (  # noqa: F401
    ACCESS_LEVELS,
    DATA,
    LOCAL,
    OMNISCIENT,
    STATS,
    Attack,
    AttackContext,
)
from repro_torch.attacks.engine import (  # noqa: F401
    apply_to_rows,
    as_attack,
    build_context,
    byzantine_mask,
    corrupt_feedback,
    corrupt_labels,
    honest_statistics,
    num_byzantine,
    payload_from_stats,
)
from repro_torch.attacks.registry import alias, get_attack, register, registered  # noqa: F401
from repro_torch.attacks.schedule import GreedyScheduler  # noqa: F401
