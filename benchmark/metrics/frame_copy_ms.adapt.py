"""``train/common.py`` -> ``data/dataset.py`` (the frames' way to the
card): device ms a step of host-to-device copies, over every job's traced
span."""

from benchmark.trace import device_seconds

LAYER = "train/common.py -> data/dataset.py frames"


def read(ctx):
    steps = sum(d["trace_units"] for d in ctx["done"])
    s = device_seconds(ctx["merged"], r"(?i)memcpy htod")
    return s * 1e3 / steps if steps and s > 0 else None
