"""The yardstick's arithmetic: peaks, least times, roofline shares, MFU
and the idle share of a traced window.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``attn_flops`` and
``kernel_split``, kept here so that a change to the
program cannot move the yardstick.  Nothing here imports the program.

Peaks are one H100 SXM's dense data-sheet rates: int8 on the tensor cores
1,979 TOP/s, bf16 989 TFLOP/s, and HBM at 3.35 TB/s.  Every f32 operation
is counted at the card's best f32-accurate rate, three TF32 products on
the tensor cores, 495 / 3 = 165 TFLOP/s, whatever path the program takes
today (the CUDA cores' 67 TFLOP/s would let a move to the tensor cores
read as more than the peak).  A
card set below its 700 W limit runs slower; the result line names the
card and the harness prints its power limit beside every run.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

PEAK_OPS = {
    "int8": 1979e12,
    "bf16": 989e12,
    "f32": 495e12 / 3,
}
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, n_bytes: float, precision: str) -> Tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time the card could
    take for this work, the larger of the operations over the precision's
    peak and the bytes (inputs read once, outputs written once) over the
    HBM rate."""
    t_ops = flops / PEAK_OPS[precision]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_flops(B: int, H: int, Sq: int, Sk: int, hd: int) -> float:
    """4 * hd operations per (query, key) pair attended: QK^T and PV."""
    return 4.0 * B * H * Sq * Sk * hd


def attn_bytes(B: int, H: int, Sq: int, Sk: int, hd: int,
               itemsize: int) -> float:
    """q, k and v read once and the output written once."""
    return float(itemsize * B * H * hd * (2 * Sq + 2 * Sk))


KINDS = (("short_attention", "K1/K3 attention"),)


def kernel_split(kernels: Iterable[Tuple[str, float]]) -> Tuple[Dict, list]:
    """Device seconds of the kernels [(name, seconds)] by kind, and the
    five largest kernels (by summed time) among the rest."""
    split = {k: 0.0 for _, k in KINDS}
    split.update({"GEMMs": 0.0, "convolutions": 0.0, "rest": 0.0})
    rest: Dict[str, float] = {}
    for n, s in kernels:
        low = n.lower()
        kind = next((k for tag, k in KINDS if tag in n), None)
        if kind:
            split[kind] += s
        elif "conv" in low or "fprop" in low or "dgrad" in low:
            split["convolutions"] += s
        elif any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet")):
            split["GEMMs"] += s
        else:
            split["rest"] += s
            rest[n[:60]] = rest.get(n[:60], 0.0) + s
    return split, sorted(rest.items(), key=lambda kv: -kv[1])[:5]


def busy_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (seconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The gaps of [lo, hi) that no interval covers, longest first."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


def share_percent(least_s: float, measured_s: float):
    """least / measured as a percentage, or None where nothing was
    measured (a metric that finds nothing to read reports nothing)."""
    if measured_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / measured_s


# ---------------------------------------------------------------------------
# model work, counted from shapes
# ---------------------------------------------------------------------------

def linear_flops(tokens: int, fan_in: int, fan_out: int) -> float:
    return 2.0 * tokens * fan_in * fan_out


def vit_block_gemm_flops(tokens: int, width: int, mlp: int) -> float:
    """qkv, proj, fc1 and fc2 of one pre-LN block over ``tokens`` rows."""
    return (linear_flops(tokens, width, 3 * width)
            + linear_flops(tokens, width, width)
            + linear_flops(tokens, width, mlp)
            + linear_flops(tokens, mlp, width))
