"""The whole step: its fp32 operations counted from shapes (the UMF over
the live splats, projection and SH, forward and backward; the composite's
evaluated pairs both ways; the loss) at the jobs' traced step rate, over
the card's 67 TFLOP/s fp32 peak, in %."""

from benchmark import counts

LAYER = "the whole step"


def read(ctx):
    cfg, c = ctx["cell"]["config"], ctx["counts"].get("face")
    if not c:
        return None
    rate = sum(d["trace_units"] / s
               for d, s in zip(ctx["done"], ctx["merged"]["spans_s"]))
    flops = counts.step_flops(cfg["init_num"], cfg["face"]["sh_degree"],
                              c["pairs"], cfg["audio_window"][1],
                              cfg["image_size"])
    return 100.0 * flops * rate / counts.FP32_OPS_PER_S
