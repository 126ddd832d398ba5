"""Per-worker gradients: a spanned step's host-clock ms less its
aggregation and update spans (every worker's forward and backward, one
after the other, and the copy of each gradient into the stacked rows),
averaged over the spanned steps."""


def read(t):
    s = t.spans
    if not s.get("step"):
        return None
    parts = [a - g - u for a, g, u in zip(s["step"], s["aggregate"], s["update"])]
    return sum(parts) / len(parts)
