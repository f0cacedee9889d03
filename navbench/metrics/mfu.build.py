"""Whole step: the least time of the model work of the traced flushes,
each part at the peak of its own precision (``_build_shapes.
flush_least_s``), as a % of the traced window."""

from navbench import arith
from navbench.metrics._build_shapes import flush_least_s


def read(out, ctx):
    if out.trace is None or not out.traced_items:
        return None
    return arith.share_percent(
        out.traced_items * flush_least_s(ctx.config), out.trace.window_s)
