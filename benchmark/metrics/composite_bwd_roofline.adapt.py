"""Kernels (``csrc/composite_bwd.cu``): the least time of a step's backward
composite on the busy tiles' work alone (3 colours, the alpha and final
transmittance, 9 feature gradients a valid slot; the reference's valid
slots, busy tiles and evaluated pairs of the step's frame) over its
device time in the trace, in %."""

from benchmark import counts
from benchmark.trace import device_seconds

LAYER = "kernels: csrc/composite_bwd.cu"


def read(ctx):
    steps = sum(d["trace_units"] for d in ctx["done"])
    s = device_seconds(ctx["merged"], r"composite_bwd")
    c = ctx["counts"].get("face")
    if not steps or s <= 0 or not c:
        return None
    least = counts.composite_bwd_bound(c["valid"], c["busy"], c["tiles"],
                                       c["pairs"], 3, 0, 9)
    return 100.0 * least * steps / s
