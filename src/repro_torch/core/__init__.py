"""Core: the paper's contribution — Byzantine-robust aggregation.

- aggregators: coordinate-wise median / trimmed-mean / mean (Defs 1-2)
- distributed: robust cross-worker collective reductions (over a mesh's
  ``Collectives``: in-process workers or a torch.distributed group)
- attacks: the AttackConfig shim over repro_torch.attacks
- robust_gd: Algorithm 1 (robust distributed GD)
- one_round: Algorithm 2 (robust one-round; ``repro_torch.rounds.one_round``)
- theory: statistical-rate formulas (Theorems 1/4, Observation 1)
"""
from repro_torch.core import (  # noqa: F401
    aggregators, attacks, distributed, one_round, robust_gd, theory)
from repro_torch.core.aggregators import (  # noqa: F401
    coordinate_mean,
    coordinate_median,
    coordinate_trimmed_mean,
    get_aggregator,
)
from repro_torch.core.attacks import AttackConfig  # noqa: F401
from repro_torch.core.robust_gd import RobustGDConfig  # noqa: F401
from repro_torch.core.one_round import OneRoundConfig  # noqa: F401
