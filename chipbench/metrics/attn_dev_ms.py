"""Attention on the device: ms a step of the subtree of the program's
``attention`` span, its backward included, over the profiled steps."""
from chipbench import spans


def read(t):
    return spans.read_metric(t, "attn_dev_ms")
