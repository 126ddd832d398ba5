"""The aggregation kernel's share of its memory roofline: the least time
the card needs to read every worker's gradient rows once and write the
aggregate once ((m + 1) · n · element bytes over the HBM bandwidth), over
the profiler's device time of ``leaf_select_kernel`` a step.  Nothing to
read where the trace holds no such kernel."""

KERNEL = "leaf_select_kernel"


def read(t):
    p = t.profile
    if t.device_type != "cuda" or not p:
        return None
    kernel_s = sum(s for name, s in p["kernel_s"].items() if KERNEL in name) / p["steps"]
    if kernel_s <= 0:
        return None
    bound_s = t.work["agg_bytes_per_step"] / t.work["hbm_bytes_per_s"]
    return 100.0 * bound_s / kernel_s
