"""Kernels (``csrc/scatter_add.cu``): the least time of a step's tile ->
splat scatter-add (9 gradient rows of each valid slot read, the live
splats' accumulator written) over the device time of its zero and
scatter kernels in the trace, in %."""

from benchmark import counts
from benchmark.trace import device_seconds

LAYER = "kernels: csrc/scatter_add.cu"


def read(ctx):
    steps = sum(d["trace_units"] for d in ctx["done"])
    s = device_seconds(ctx["merged"], r"scatter_add_kernel|^void zero_kernel")
    c = ctx["counts"].get("face")
    if not steps or s <= 0 or not c:
        return None
    least = counts.scatter_add_bound(c["valid"], c["tiles"], 9,
                                     ctx["cell"]["config"]["init_num"])
    return 100.0 * least * steps / s
