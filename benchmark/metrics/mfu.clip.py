"""The whole frame: its fp32 operations counted from shapes (both
branches' motion nets over the live splats, the audio encoders,
projection and SH, the composite's evaluated pairs, dilation and fusion)
at the clients' traced frame rate, over the card's 67 TFLOP/s fp32 peak,
in %."""

from benchmark import counts

LAYER = "the whole frame"


def read(ctx):
    cfg, c = ctx["cell"]["config"], ctx["counts"]
    if not c:
        return None
    rate = sum(d["trace_units"] / s
               for d, s in zip(ctx["done"], ctx["merged"]["spans_s"]))
    flops = counts.frame_flops(
        cfg["face"]["live"], cfg["mouth"]["live"],
        (cfg["face"]["sh_degree"], cfg["mouth"]["sh_degree"]),
        c["face"]["pairs"] + c["mouth"]["pairs"],
        cfg["audio_window"][1], cfg["image_size"])
    return 100.0 * flops * rate / counts.FP32_OPS_PER_S
