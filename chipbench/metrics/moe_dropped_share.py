"""The (token, top-k slot) pairs no expert keeps: 100 times 1 less the
program's counter ``moe.kept`` over ``moe.pairs``, over the profiled
steps."""
from chipbench import spans


def read(t):
    return spans.read_metric(t, "moe_dropped_share")
