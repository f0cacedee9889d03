"""int8 W8A8 linear: symmetric per-output-channel int8 weights times
dynamic per-row int8 activations, accumulated in int32.

Counterpart of ``bsc_nav_tpu/ops/quant.py:35-67``.  Quantized leaves are
plain dicts ``{"w_q" int8 [fi, fo], "w_s" f32 [fo], "b"?}`` and ``linear``
dispatches on the presence of ``"w_q"``, as in the JAX package.

The JAX package leaves the int8 product to XLA (no Pallas kernel), so the
port leaves it to PyTorch: ``torch._int_mm`` on a CUDA tensor, which needs
more than 16 rows and both widths a multiple of 8 (the CLIP towers' are);
anything else raises rather than taking a float path on the card.  On the
CPU the product is a float64 matmul of the int8 values, exact at these
sizes (|sum| <= 127^2 * fan_in < 2^53), so both sides give the same int32
sums.  The activation scale divides (``xf / xs``), as the JAX source
writes it.

``conv_q8`` and ``quantize_conv_weight`` wait for YOLO-World (ROADMAP.md
Queue 1 item 2).
"""

from __future__ import annotations

from typing import Mapping

import torch


def quantize_weight(p: Mapping[str, torch.Tensor]) -> dict:
    """{"w": [fi, fo], "b"?} -> {"w_q" int8, "w_s" f32 [fo], "b"?}."""
    w = p["w"].to(torch.float32)
    s = torch.clamp(w.abs().amax(dim=0), min=1e-12) / 127.0
    q = {"w_q": torch.round(w / s).to(torch.int8), "w_s": s}
    if p.get("b") is not None:
        q["b"] = p["b"]
    return q


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 -> [M, N] int32 sums."""
    if xq.device.type == "cpu":
        return (xq.double() @ wq.double()).to(torch.int32)
    M, K = xq.shape
    N = wq.shape[1]
    if M <= 16 or K % 8 or N % 8:
        raise NotImplementedError(
            f"linear_q8: int8 GEMM [{M}, {K}] x [{K}, {N}] on {xq.device} "
            "needs M > 16 and K, N multiples of 8 (torch._int_mm)")
    return torch._int_mm(xq, wq.contiguous())


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
    ``x.dtype`` that ``vit._linear``'s f32 einsum and cast make."""
    if "w_q" in p:
        return linear_q8(x, p)
    ct = torch.promote_types(x.dtype, p["w"].dtype)
    x2 = x.reshape(-1, x.shape[-1]).to(ct)
    w = p["w"].to(ct)
    b = p.get("b")
    y = torch.addmm(b.to(ct), x2, w) if b is not None else x2 @ w
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)
