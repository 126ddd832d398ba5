"""Federated-scale simulation: virtual client populations, the streaming
histogram sketch (through the min/max and histogram CUDA kernels on the
card) and synchronous cohort rounds.

- population: lazily generated linear-regression clients
- streaming:  the two-pass chunked sketch aggregator
- rounds:     cohort sampling -> (payload codec) -> chunked robust
              aggregation -> optimizer
- async_rounds: buffered asynchronous rounds (first-k arrivals, pending
              queue, staleness policies from ``staleness``; the arrival
              model is ``population.ArrivalConfig``)
- run:        the CLI, ``python -m repro_torch.fed.run``
"""
from repro_torch.fed import async_rounds, population, rounds, staleness, streaming  # noqa: F401
from repro_torch.fed.async_rounds import AsyncConfig, run_async_rounds  # noqa: F401
from repro_torch.fed.population import (  # noqa: F401
    ArrivalConfig,
    ClientPopulation,
    PopulationConfig,
    sample_latencies,
)
from repro_torch.fed.rounds import (  # noqa: F401
    STREAMING_METHODS,
    AttackMixture,
    RoundConfig,
    aggregate_cohort,
    run_rounds,
)
from repro_torch.fed.streaming import (  # noqa: F401
    SketchConfig,
    aggregate_array_chunked,
    streaming_aggregate,
    streaming_aggregate_multi,
)
from repro_torch.fed.staleness import (  # noqa: F401
    StalenessPolicySpec,
    apply_policy,
    get_policy,
    register_policy,
    registered_policies,
)
