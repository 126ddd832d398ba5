"""The device's idle share over the profiled steps: 1 less the union of
its activity intervals over the host-clock length of those steps."""


def read(t):
    p = t.profile
    if t.device_type != "cuda" or not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
