"""Shapes and least times of the detector's model work in the memory
build with the MetaCLIP patch detector, counted from the configuration
file's ``detector`` (never from the program's launches)."""

from __future__ import annotations

from navbench import arith
from navbench.metrics import _build_shapes

PRECISION = {"bfloat16": "bf16", "float32": "f32"}


def vit_h(c: dict) -> dict:
    d = c["detector"]
    g = d["image_size"] // d["patch_size"]
    return {"B": c["batch"], "S": g * g + 1, "H": d["vision_heads"],
            "hd": d["vision_width"] // d["vision_heads"],
            "depth": d["vision_layers"], "dim": d["vision_width"],
            "mlp": d["vision_mlp"], "embed": d["embed_dim"],
            "patches": g * g, "patch_in": d["patch_size"] ** 2 * 3,
            "precision": PRECISION[d["dtype"]],
            "itemsize": 2 if d["dtype"] == "bfloat16" else 4}


def k3_call_s(c: dict) -> float:
    """The detector's attention, one call (all heads of the batch)."""
    v = vit_h(c)
    f = arith.attn_flops(v["B"], v["H"], v["S"], v["S"], v["hd"])
    b = arith.attn_bytes(v["B"], v["H"], v["S"], v["S"], v["hd"],
                         v["itemsize"])
    return arith.bound(f, b, v["precision"])[0]


def k3_calls(c: dict) -> int:
    """Attention calls a flush: every block but the last, whose value
    path has none."""
    return vit_h(c)["depth"] - 1


def detector_least_s(c: dict) -> float:
    """The least time of one flush's dense detector: the patch
    embedding, every block but the last, the last block's value path
    (v and the out-projection) and the patch tokens' projection at the
    peak of its stated precision, and the attention at its bound."""
    v = vit_h(c)
    T = v["B"] * v["S"]
    P = v["B"] * v["patches"]
    flops = (k3_calls(c) * arith.vit_block_gemm_flops(T, v["dim"], v["mlp"])
             + 2 * arith.linear_flops(T, v["dim"], v["dim"])
             + arith.linear_flops(P, v["patch_in"], v["dim"])
             + arith.linear_flops(P, v["dim"], v["embed"]))
    return flops / arith.PEAK_OPS[v["precision"]] + k3_calls(c) * k3_call_s(c)


def flush_least_s(c: dict) -> float:
    """A flush's model work: the memory's encoder and the detector, each
    at the peak of its own precision."""
    return _build_shapes.flush_least_s(c) + detector_least_s(c)
