"""``models/motion.py`` -> ``ops/hashgrid.py`` backward: device ms a step
of the indexed gathers' backward (``index_put_``'s accumulate kernel), by
name, over every job's traced span."""

from benchmark.trace import device_seconds

LAYER = "models/motion.py -> ops/hashgrid.py backward"


def read(ctx):
    steps = sum(d["trace_units"] for d in ctx["done"])
    s = device_seconds(ctx["merged"], r"indexing_backward_kernel")
    return s * 1e3 / steps if steps and s > 0 else None
