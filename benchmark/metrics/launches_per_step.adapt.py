"""Host dispatch (``train/face.py`` -> ``train/common.py``): kernel
launches a step, counted from the profiler's runtime launch events of
every job over the steps of their traced spans."""

LAYER = "host dispatch: train/face.py -> train/common.py"


def read(ctx):
    steps = sum(d["trace_units"] for d in ctx["done"])
    return ctx["merged"]["launches"] / steps if steps else None
