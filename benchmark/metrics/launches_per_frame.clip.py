"""Host dispatch (``synthesize.py`` -> ``render.py``): kernel launches a
frame, counted from the profiler's runtime launch events of every client
over the frames their traced spans delivered."""

LAYER = "host dispatch: synthesize.py -> render.py"


def read(ctx):
    frames = sum(d["trace_units"] for d in ctx["done"])
    return ctx["merged"]["launches"] / frames if frames else None
