"""The share of the traced slice in which no operation ran on the card:
one minus the union of the device operations' intervals over the slice's
wall time (device layer)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["window_s"] > 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
