"""The optimizer: host-clock ms a step inside the span around the
optimizer's ``update``."""


def read(t):
    s = t.spans.get("update")
    return sum(s) / len(s) if s else None
