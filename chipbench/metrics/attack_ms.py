"""The attack on the stacked rows: host-clock ms a step inside the spans
around ``repro_torch.core.distributed._maybe_attack``."""


def read(t):
    s = t.spans.get("attack")
    return sum(s) / len(s) if s else None
