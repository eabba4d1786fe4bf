"""``ops/rasterize.py``'s exact tile selection: device ms a frame of the
top-k's kernels (digit counts and cumulative sums, the radix sort, the
gather of the top-k), by name, over every client's traced span."""

from benchmark.trace import device_seconds

LAYER = "ops/rasterize.py tile_select"
PATTERN = r"(?i)topk|radixsort|digitcount|digitcumsum"


def read(ctx):
    frames = sum(d["trace_units"] for d in ctx["done"])
    s = device_seconds(ctx["merged"], PATTERN)
    return s * 1e3 / frames if frames and s > 0 else None
