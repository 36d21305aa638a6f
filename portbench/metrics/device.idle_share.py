"""device.idle_share: the share of the traced stretch, in %, in which no
operation ran on the card: 1 - (the union of the device intervals) / (the
stretch's wall time)."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
