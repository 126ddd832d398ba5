"""Core: the paper's contribution — Byzantine-robust aggregation.

- aggregators: coordinate-wise median / trimmed-mean / mean (Defs 1-2)
- attacks: the AttackConfig shim over repro_torch.attacks
- robust_gd: Algorithm 1 (robust distributed GD)
- theory: statistical-rate formulas (Theorems 1/4, Observation 1)
"""
from repro_torch.core import aggregators, attacks, robust_gd, theory  # noqa: F401
from repro_torch.core.aggregators import (  # noqa: F401
    coordinate_mean,
    coordinate_median,
    coordinate_trimmed_mean,
    get_aggregator,
)
from repro_torch.core.attacks import AttackConfig  # noqa: F401
from repro_torch.core.robust_gd import RobustGDConfig  # noqa: F401
