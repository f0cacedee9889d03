"""3x3 stride-1 'SAME' NHWC convolution: kernel K8, its plain version and
the conv + BatchNorm fold; and the "SAME" NHWC convolution of any other
shape, on cuDNN.

Counterpart of ``bsc_nav_tpu/ops/conv2d.py`` ``conv3x3_s1`` / ``fold_bn``,
which the JAX package keeps as a measured result on the TPU and dispatches
nowhere (its YOLO stack uses ``lax.conv``).  The port dispatches it: the
YOLO-World detector (``models/yolo_world.py``) sends every 3x3 stride-1
conv with f32 activations to K8, its BN folded once at load, and every
other conv to ``conv2d_same`` (cuDNN with TF32 off), where K8 measured
faster than cuDNN in f32 and slower in bf16 (PERF.md section 6).  Unlike
the TPU kernel it takes any C, CO, H and W, YOLOv8x's widths 80, 160 and
320 included.  Both dtypes run on the tensor cores: bf16 products
directly, f32 products as three TF32 products each (f32's error, not one
TF32 product's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bsc_nav_tpu_torch.ops import _build
from bsc_nav_tpu_torch.ops.quant import same_padding


def conv3x3_s1_reference(x, w9, bias, act: str = "silu"):
    """Plain version of K8: what ``_kernel`` computes, in f32 -- the sum over
    the nine taps of the zero-padded, shifted input times that tap's
    [C, CO] weights, plus the bias, then x * sigmoid(x) when act is
    "silu" -- cast back to x's dtype."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))        # W and H by one each side
    w = w9.float()
    acc = sum(xp[:, dy:dy + H, dx:dx + W, :] @ w[3 * dy + dx]
              for dy in range(3) for dx in range(3)) + bias.float()
    if act == "silu":
        acc = acc * torch.sigmoid(acc)
    return acc.to(x.dtype)


def conv3x3_s1(x, w9, bias, act: str = "silu"):
    """x [B, H, W, C]; w9 [9, C, CO] (tap-major HWIO flattened, x's dtype);
    bias [CO] (BN pre-folded, taken as f32) -> [B, H, W, CO] in x's dtype.
    act "silu" fuses x * sigmoid(x); anything else applies none, as in the
    JAX package.

    A CPU tensor takes ``conv3x3_s1_reference``.  A CUDA tensor launches
    kernel K8 (``csrc/conv3x3_s1.cu``) on the current stream without
    synchronising, or raises for what it does not take.
    """
    B, H, W, C = x.shape
    if w9.dim() != 3 or w9.shape[:2] != (9, C) or bias.shape != w9.shape[2:]:
        raise ValueError(f"conv3x3_s1: x {tuple(x.shape)}, w9 "
                         f"{tuple(w9.shape)}, bias {tuple(bias.shape)} are "
                         "not [B, H, W, C], [9, C, CO], [CO]")
    if x.device.type == "cpu":
        return conv3x3_s1_reference(x, w9, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_s1: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w9.dtype != x.dtype:
        raise TypeError(f"conv3x3_s1: x {x.dtype}, w9 {w9.dtype} (kernel "
                        "takes float32 or bfloat16, both alike)")
    if not (x.is_contiguous() and w9.is_contiguous()):
        raise ValueError("conv3x3_s1: x and w9 must be contiguous")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or w9.data_ptr() % 16):
        raise ValueError("conv3x3_s1: bf16 x and w9 must be 16-byte aligned "
                         "(the tensor-core kernel copies 16-byte runs)")
    CO = w9.shape[2]
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(B, H, W, CO, dtype=x.dtype, device=x.device)
    rc = _build.kernels().conv3x3_s1_launch(
        x.data_ptr(), w9.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W,
        C, CO, int(act == "silu"), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "conv3x3_s1")
    conv3x3_s1.launches += 1
    return out


conv3x3_s1.launches = 0


def fold_bn(w_hwio, bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-3):
    """Conv + BN -> conv weights [9, C, CO] in w's dtype and an f32 bias
    [CO] for ``conv3x3_s1`` (``conv2d.py:148-155``)."""
    s = bn_scale / torch.sqrt(bn_var + eps)
    w = (w_hwio * s).to(w_hwio.dtype)
    b = (bn_bias - bn_mean * s).to(torch.float32)
    k, _, C, CO = w.shape
    return w.reshape(k * k, C, CO), b


def conv2d_same(x, w_hwio, stride: int = 1):
    """x [B, H, W, C], w [kh, kw, C, CO] in x's dtype -> [B, oh, ow, CO] in
    x's dtype: ``lax.conv_general_dilated(..., "SAME", ("NHWC", "HWIO",
    "NHWC"))``, XLA's padding included (an odd total pads one more at the
    high end).  One ``F.conv2d`` on the channels-last view; on a CUDA
    tensor cuDNN runs it with TF32 off for this call alone, so f32 stays
    f32 whatever the process's flags say (the other cuDNN flags keep
    their values).  Not a kernel of the port: the JAX package leaves these
    convs to XLA."""
    kh, kw = w_hwio.shape[:2]
    (ht, hb), (wl, wr) = (same_padding(x.shape[1], kh, stride),
                          same_padding(x.shape[2], kw, stride))
    pad = (ht, wl)
    if (ht, wl) != (hb, wr):
        x, pad = F.pad(x, (0, 0, wl, wr, ht, hb)), (0, 0)
    xc = x.permute(0, 3, 1, 2)                  # NCHW view, NHWC memory
    wc = w_hwio.permute(3, 2, 0, 1)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv2d(xc, wc, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()
