"""The attack on the device: ms a step of the subtree of the program's
``attack`` span, over the profiled steps."""
from chipbench import spans


def read(t):
    return spans.read_metric(t, "attack_dev_ms")
