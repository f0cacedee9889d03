"""Shapes and least times of the memory build's model work, counted from
the configuration file (never from the program's launches)."""

from __future__ import annotations

from navbench import arith

PRECISION = {"bfloat16": "bf16", "float32": "f32"}


def vit_l(c: dict) -> dict:
    e = c["encoder"]
    g = c["query"]["query_width"] // e["patch_size"]
    S = g * g + 1 + e["num_registers"]
    return {"B": c["batch"], "S": S, "H": e["heads"],
            "hd": e["dim"] // e["heads"], "depth": e["depth"],
            "dim": e["dim"], "mlp": int(e["dim"] * e["mlp_ratio"]),
            "patches": g * g, "patch_in": e["patch_size"] ** 2 * 3,
            "precision": PRECISION[e["dtype"]],
            "itemsize": 2 if e["dtype"] == "bfloat16" else 4}


def k1_call_s(c: dict) -> float:
    """The encoder's attention, one call (all heads of the batch)."""
    v = vit_l(c)
    f = arith.attn_flops(v["B"], v["H"], v["S"], v["S"], v["hd"])
    b = arith.attn_bytes(v["B"], v["H"], v["S"], v["S"], v["hd"],
                         v["itemsize"])
    return arith.bound(f, b, v["precision"])[0]


def flush_least_s(c: dict) -> float:
    """The least time of one flush's model work: the encoder's patch
    embedding and block GEMMs at the peak of its stated precision, and
    its attention at K1's bound."""
    v = vit_l(c)
    T = v["B"] * v["S"]
    flops = (v["depth"] * arith.vit_block_gemm_flops(T, v["dim"], v["mlp"])
             + arith.linear_flops(v["B"] * v["patches"], v["patch_in"],
                                  v["dim"]))
    return (flops / arith.PEAK_OPS[v["precision"]]
            + v["depth"] * k1_call_s(c))


def window_span_ms(out, name: str):
    """Mean milliseconds of the span ``name`` over the window's flushes
    before the traced part."""
    lo, hi = out.window_t0, out.traced_t0
    d = out.spans.durations(name, lo, hi)
    return 1e3 * sum(d) / len(d) if d else None
