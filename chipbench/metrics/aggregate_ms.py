"""The aggregation's self time: host-clock ms a step inside the span
around ``repro_torch.rounds.distributed.aggregate_by_strategy``, less the
attack's span inside it."""


def read(t):
    s = t.spans
    if not s.get("aggregate"):
        return None
    parts = [a - k for a, k in zip(s["aggregate"], s["attack"])]
    return sum(parts) / len(parts)
