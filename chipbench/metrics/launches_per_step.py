"""Kernel launches a step: the device activities of the profiled steps,
memory copies and sets left out, over those steps."""


def read(t):
    p = t.profile
    if t.device_type != "cuda" or not p or p["launches"] == 0:
        return None
    return p["launches"] / p["steps"]
