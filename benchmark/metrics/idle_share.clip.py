"""The device: the share of the clients' common traced span in which no
client's operation ran on the card (one minus the union of their device
intervals over the span), in %."""

LAYER = "device"


def read(ctx):
    m = ctx["merged"]
    return 100.0 * (1.0 - m["busy_s"] / m["window_s"])
