"""The aggregation on the device: ms a step of the subtree of the
program's ``aggregate`` span less its ``attack`` span, over the
profiled steps."""
from chipbench import spans


def read(t):
    return spans.read_metric(t, "aggregate_dev_ms")
