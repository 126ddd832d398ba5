"""Per-worker gradients on the device: ms a step of the subtree of the
program's ``worker.grads`` span (every worker's forward, backward and
recompute, and the copy into the stacked rows), over the profiled steps."""
from chipbench import spans


def read(t):
    return spans.read_metric(t, "grads_dev_ms")
