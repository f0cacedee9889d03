"""Whole step: the least time of the model work of the traced flushes --
ViT-L at its precision and the MetaCLIP detector at its own, each at the
peak of its precision (``_cliph_shapes.flush_least_s``) -- as a % of the
traced window."""

from navbench import arith
from navbench.metrics._cliph_shapes import flush_least_s


def read(out, ctx):
    if out.trace is None or not out.traced_items:
        return None
    return arith.share_percent(
        out.traced_items * flush_least_s(ctx.config), out.trace.window_s)
