"""Kernels (``csrc/composite_fwd.cu``): the least time of the synthesis
frame's two forward composites (face and mouth; 3 colours, alpha and the
final transmittance needed, counted from the reference's valid slots and
evaluated pairs) over their device time in the trace, in %."""

from benchmark import counts
from benchmark.trace import device_seconds

LAYER = "kernels: csrc/composite_fwd.cu"


def read(ctx):
    frames = sum(d["trace_units"] for d in ctx["done"])
    s = device_seconds(ctx["merged"], r"composite_fwd")
    c = ctx["counts"]
    if not frames or s <= 0 or not c:
        return None
    least = sum(counts.composite_fwd_bound(c[b]["valid"], c[b]["tiles"],
                                           c[b]["pairs"], 3)
                for b in ("face", "mouth"))
    return 100.0 * least * frames / s
