"""The optimizer on the device: ms a step of the subtree of the program's
``update`` span, over the profiled steps."""
from chipbench import spans


def read(t):
    return spans.read_metric(t, "update_dev_ms")
