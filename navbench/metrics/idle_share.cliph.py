"""Device: % of the traced window in which no operation ran on the card."""


def read(out, ctx):
    if out.trace is None or out.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - out.trace.busy_s() / out.trace.window_s)
