"""The attention score elements the mask keeps: 100 times the program's
counter ``attn.kept`` over ``attn.scores``, over the profiled steps."""
from chipbench import spans


def read(t):
    return spans.read_metric(t, "attn_kept_share")
