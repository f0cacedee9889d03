"""K1's share of its roofline in the traced window: the least time of the
encoder's attention calls the traced flushes make (depth calls a flush at
B 8, S 261, 16 x 64, in the encoder's precision), over the device time of
the kernels named below."""

from navbench import arith
from navbench.metrics._build_shapes import k1_call_s, vit_l

NAMES = ("attention_wgmma_kernel",)


def read(out, ctx):
    if out.trace is None or not out.traced_items:
        return None
    calls = out.traced_items * vit_l(ctx.config)["depth"]
    t = out.trace.kernel_seconds(lambda n: any(k in n for k in NAMES))
    return arith.share_percent(calls * k1_call_s(ctx.config), t)
