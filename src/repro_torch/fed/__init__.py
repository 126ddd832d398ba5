"""Federated-scale simulation: virtual client populations, the streaming
histogram sketch (through the min/max and histogram CUDA kernels on the
card) and synchronous cohort rounds.

- population: lazily generated linear-regression clients
- streaming:  the two-pass chunked sketch aggregator
- rounds:     cohort sampling -> chunked robust aggregation -> optimizer
- run:        the CLI, ``python -m repro_torch.fed.run``

The reference's buffered async rounds (``async_rounds``, ``staleness``
and the arrival model) are not ported yet.
"""
from repro_torch.fed.population import ClientPopulation, PopulationConfig  # noqa: F401
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
