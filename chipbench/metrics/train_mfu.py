"""The whole step's share of the card's bf16 peak: the model FLOPs of the
bare steps (the reference module's ``model_flops_per_step``) over their
host-clock time and 989 TFLOP/s.  Only a run on the card has a share of its peak."""


def read(t):
    b = t.bare
    if t.device_type != "cuda" or not b or b["wall_s"] <= 0:
        return None
    flops = t.work["model_flops_per_step"] * b["steps"]
    return 100.0 * flops / (b["wall_s"] * t.work["peak_flops"])
