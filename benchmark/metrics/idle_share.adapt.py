"""The device: the share of the jobs' common traced span in which no
job's operation ran on the card, in %."""

LAYER = "device"


def read(ctx):
    m = ctx["merged"]
    return 100.0 * (1.0 - m["busy_s"] / m["window_s"])
