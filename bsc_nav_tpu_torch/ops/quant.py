"""int8 W8A8 linear and convolution: symmetric per-output-channel int8
weights times dynamic int8 activations (a scale per row for the linear,
per sample for the convolution), accumulated in int32.

Counterpart of ``bsc_nav_tpu/ops/quant.py``.  Quantized leaves are
plain dicts ``{"w_q" int8 [fi, fo], "w_s" f32 [fo], "b"?}`` and ``linear``
dispatches on the presence of ``"w_q"``, as in the JAX package.

The JAX package leaves the int8 product to XLA (no Pallas kernel), so the
port leaves it to PyTorch: ``torch._int_mm`` on a CUDA tensor, which needs
more than 16 rows and both widths a multiple of 8 -- and on the H100 the
cuBLASLt int8 product it calls refuses a depth K under 128 once N is 32 or
more (CUBLAS_STATUS_NOT_SUPPORTED unless M is a multiple of 32;
``chip_smoke.py``'s ``vlm`` phase counts the refusals over a grid of
shapes).  XLA's dot takes every shape, so the port pads the operands with
zeros up to what the card takes (``int8_gemm_shape``,
``padded_int8_matmul``) and slices the result:
zero rows and columns add nothing to any int32 sum, so the sums are exact.
A decode step's matvec (M = 1) pads its one activation row; a width not a
multiple of 8 (the Qwen vision MLP's 3420, quantized only under
``scope="vision"`` / ``"all"``) pads, and so copies, the weight per call.
On the CPU the product is a float64 matmul of the int8 values, exact at
these sizes (|sum| <= 127^2 * fan_in < 2^53), so both sides give the same
int32 sums.  The activation scale divides (``xf / xs``), as the JAX source
writes it.

``conv_q8`` (``lax.conv`` on int8 in the JAX package) is the same product
on the im2col rows of the quantized input: [B * oh * ow, kh * kw * C] x
[kh * kw * C, CO].  YOLOv8x's quantized leaves all give more than 16 rows
and widths in multiples of 8 at full width.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F


def weight_scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-12) / 127 as a true division on every device, as the
    JAX package's eager quantizers compute it: PyTorch divides a CUDA
    tensor by a Python scalar as a product with the scalar's f32
    reciprocal, which differs in the last bit for some scales (and then
    moves the codes rounded at a half)."""
    a = torch.clamp(absmax, min=1e-12)
    return a / torch.full_like(a, 127.0)


def quantize_weight(p: Mapping[str, torch.Tensor]) -> dict:
    """{"w": [fi, fo], "b"?} -> {"w_q" int8, "w_s" f32 [fo], "b"?}."""
    w = p["w"].to(torch.float32)
    s = weight_scale(w.abs().amax(dim=0))
    q = {"w_q": torch.round(w / s).to(torch.int8), "w_s": s}
    if p.get("b") is not None:
        q["b"] = p["b"]
    return q


def int8_gemm_shape(M: int, K: int, N: int) -> tuple:
    """(Mp, Kp, Np): sizes at least (M, K, N) that ``torch._int_mm`` takes
    on the card -- more than 16 rows (M <= 16 pads to 24, the next
    multiple of 8), K a multiple of 8 and at least 128, N a multiple of
    8."""
    return (M if M > 16 else 24, max(-(-K // 8) * 8, 128), -(-N // 8) * 8)


def padded_int8_matmul(xq: torch.Tensor, wq: torch.Tensor,
                       mm=torch._int_mm) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 -> [M, N] int32 by ``mm`` on operands
    zero-padded to ``int8_gemm_shape``: the padded rows and columns add
    zeros to every sum, and the padding is sliced off.  Padding K or N
    copies the weight on every call."""
    M, K = xq.shape
    N = wq.shape[1]
    Mp, Kp, Np = int8_gemm_shape(M, K, N)
    if (Mp, Kp) != (M, K):
        xq = F.pad(xq, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        wq = F.pad(wq, (0, Np - N, 0, Kp - K))
    y = mm(xq.contiguous(), wq.contiguous())
    return y[:M, :N] if (Mp, Np) != (M, N) else y


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 -> [M, N] int32 sums, any shape."""
    if xq.device.type == "cpu":
        return (xq.double() @ wq.double()).to(torch.int32)
    return padded_int8_matmul(xq, wq)


def linear_q8(x: torch.Tensor, p: Mapping[str, torch.Tensor]
              ) -> torch.Tensor:
    """y = x @ w + b with int32 accumulation and an f32 epilogue.
    x: [..., fi], any float dtype; returns x.dtype."""
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    xq = torch.round(xf / xs).to(torch.int8)
    y = _int8_matmul(xq.contiguous(), p["w_q"]).to(torch.float32)
    y = y * xs * p["w_s"].to(torch.float32)
    if p.get("b") is not None:
        y = y + p["b"].to(torch.float32)
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def linear(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Dispatching linear: quantized ({"w_q", ...}) or plain ({"w", ...}).
    A plain leaf computes in the promoted dtype of ``x`` and ``w``, as
    ``vit.Linear`` does: cuBLAS accumulates a bf16 product in f32 and adds
    the bias in that accumulator (addmm) before the one rounding to
    ``x.dtype`` that ``vit._linear``'s f32 einsum and cast make.  A leaf
    with a ``"tp"`` split (``parallel/mesh.shard_mmdit_params``) is this
    rank's shard: row-parallel leaves all-reduce their product
    (``TPSplit.row_linear``), column-parallel ones return this rank's
    columns."""
    if "w_q" in p:
        return linear_q8(x, p)
    tp = p.get("tp")
    if tp is not None and tp.kind == "row":
        return tp.row_linear(x, p["w"], p.get("b"))
    ct = torch.promote_types(x.dtype, p["w"].dtype)
    x2 = x.reshape(-1, x.shape[-1]).to(ct)
    w = p["w"].to(ct)
    b = p.get("b")
    y = torch.addmm(b.to(ct), x2, w) if b is not None else x2 @ w
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def full_columns(y: torch.Tensor, tp) -> torch.Tensor:
    """The whole output of a linear leaf whose tensor-parallel split is
    ``tp`` (``parallel/mesh.TPSplit``): all-gathered over mp when it is
    column-parallel, ``y`` as it is otherwise."""
    return tp.gather(y) if tp is not None and tp.kind == "col" else y


def quantize_conv_weight(p: Mapping[str, torch.Tensor]) -> dict:
    """Conv leaf {"w": [kh, kw, ci, co], **rest} -> {"w_q" int8, "w_s" f32
    [co], **rest}: per-output-channel symmetric scaling; the BN statistics
    and bias pass through untouched."""
    w = p["w"].to(torch.float32)
    s = weight_scale(w.abs().amax(dim=(0, 1, 2)))
    q = {k: v for k, v in p.items() if k != "w"}
    q["w_q"] = torch.round(w / s).to(torch.int8)
    q["w_s"] = s
    return q


def same_padding(size: int, k: int, stride: int) -> tuple:
    """(low, high) padding of one spatial axis under XLA's "SAME": the
    output has ceil(size / stride) positions and an odd total pads one more
    at the high end (a 3x3 stride-2 conv of an even size pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def im2col_same(x: torch.Tensor, kh: int, kw: int, stride: int
                ) -> torch.Tensor:
    """[B, H, W, C] -> [B, oh, ow, kh * kw * C]: each output position's
    window under "SAME" padding with zeros, taps in (kh, kw, C) order,
    the order of an HWIO weight flattened."""
    if kh == kw == 1 and stride == 1:
        return x
    (ht, hb), (wl, wr) = (same_padding(x.shape[1], kh, stride),
                          same_padding(x.shape[2], kw, stride))
    xp = F.pad(x, (0, 0, wl, wr, ht, hb))
    cols = xp.unfold(1, kh, stride).unfold(2, kw, stride)  # B,oh,ow,C,kh,kw
    B, oh, ow = cols.shape[:3]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(B, oh, ow, -1)


def conv_q8(x: torch.Tensor, p: Mapping[str, torch.Tensor],
            stride: int = 1) -> torch.Tensor:
    """NHWC "SAME" conv with int8 products summed in int32; returns the f32
    pre-affine output (the caller applies the BN or bias and the
    activation).  The activation scale is one per sample, max |x| over
    (H, W, C) / 127 (a scale per pixel is not expressible as a conv); the
    weights take quantize_conv_weight's scale per output channel."""
    xf = x.to(torch.float32)
    xs = torch.clamp(xf.abs().amax(dim=(1, 2, 3), keepdim=True),
                     min=1e-12) / 127.0
    xq = torch.round(xf / xs).to(torch.int8)
    kh, kw, C, CO = p["w_q"].shape
    cols = im2col_same(xq, kh, kw, stride)
    B, oh, ow, K = cols.shape
    y = _int8_matmul(cols.reshape(B * oh * ow, K).contiguous(),
                     p["w_q"].reshape(K, CO))
    y = y.reshape(B, oh, ow, CO).to(torch.float32)
    return y * xs * p["w_s"].to(torch.float32)
