"""repro_torch.rounds — the communication-round subsystem.

- ``comm``         per-strategy byte accounting (:class:`CommBudget`, the
                   StrategySpec registry), attack-vs-strategy access
                   validation and attack resolution;
- ``compression``  the payload codecs (none, int8, topk with error
                   feedback, count_sketch) and their byte models;
- ``engine``       the round engine: pluggable (local work, compression,
                   attack, aggregation, update) stages over one RoundState,
                   the scan and scheduled drivers, checkpoint/resume;
- ``one_round``    Algorithm 2 (paper Section 5, Theorem 7): the vmap path
                   and the streaming-histogram path at federated scale;
- ``local_update`` robust local-update GD — τ local steps per robust
                   aggregation, from Algorithm 1 (τ = 1, bit for bit
                   robust_gd) to the one-round algorithm (τ = ∞);
- ``distributed``  the round programs over a worker axis (Algorithm 2 and
                   local-update rounds as distributed programs over any
                   ``core.distributed.Collectives``: the in-process mesh or
                   a ``torch.distributed`` process group) and the
                   strategy-name dispatcher the train step shares.
"""
from repro_torch.rounds.comm import (  # noqa: F401
    CommBudget,
    StrategySpec,
    get_strategy_spec,
    register_strategy,
    registered_strategies,
    resolve_attack,
    validate_attack_strategy,
)
from repro_torch.rounds.compression import (  # noqa: F401
    CompressionSpec,
    breakdown_alpha,
    compress_rows,
    compress_tree,
    compress_tree_rows,
    get_compression,
    init_residual,
    register_compression,
    registered_compressions,
    roundtrip,
    validate_compression_context,
)
from repro_torch.rounds.distributed import (  # noqa: F401
    aggregate_by_strategy,
    make_local_update_round,
    one_round_distributed,
)
from repro_torch.rounds.engine import (  # noqa: F401
    RoundStages,
    latest_round,
    load_snapshot,
    make_round_body,
    make_state,
    run_scan,
    run_scheduled,
    save_snapshot,
    snapshot_rounds,
)
from repro_torch.rounds.local_update import (  # noqa: F401
    LocalUpdateConfig,
    local_update_gd,
    make_local_update_stages,
    run_local_update_rounds,
)
from repro_torch.rounds.one_round import (  # noqa: F401
    OneRoundConfig,
    make_gd_local_solver,
    one_round,
    one_round_streaming,
    quadratic_local_solver,
)
