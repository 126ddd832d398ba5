"""The MoE on the device: ms a step of the subtrees of the program's
``moe.route`` and ``moe.experts`` spans, backward included, over the
profiled steps."""
from chipbench import spans


def read(t):
    return spans.read_metric(t, "moe_dev_ms")
