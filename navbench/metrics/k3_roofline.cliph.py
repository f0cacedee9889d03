"""K3's share of its roofline in the traced window: the least time of the
detector's attention calls the traced flushes make (every block but the
last a flush, at B 8, S 257, 16 x 80, in the detector's precision), over
the device time of K3's kernels (``short_attention`` on the f32 tile;
ViT-L's K1 runs on another)."""

from navbench import arith
from navbench.metrics._cliph_shapes import k3_call_s, k3_calls


def is_k3(name: str) -> bool:
    return ("attention_tf32_kernel" in name and "short_attention" in name
            and "short_attention_qkv" not in name)


def read(out, ctx):
    if out.trace is None or not out.traced_items:
        return None
    calls = out.traced_items * k3_calls(ctx.config)
    t = out.trace.kernel_seconds(is_k3)
    return arith.share_percent(calls * k3_call_s(ctx.config), t)
