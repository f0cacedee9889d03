"""Row LayerNorm: kernel K7 and its plain version.

Counterpart of ``bsc_nav_tpu/ops/layernorm.py`` ``layer_norm_tpu``, which
the JAX package keeps as a measured negative on the TPU and dispatches
nowhere (``models/vit.py`` normalises with jnp).  The port keeps it the
same way: ``layer_norm`` here is an op that no model calls
(``models/vit.py`` uses ``F.layer_norm``); ``chip_smoke.py`` holds it
against its plain version and against ``F.layer_norm`` on the card.
"""

from __future__ import annotations

import torch

from bsc_nav_tpu_torch.ops import _build


def layer_norm_reference(x, scale, bias, eps: float = 1e-6):
    """Plain version of K7: what ``_ln_kernel`` computes, in f32 -- the
    mean, the centred variance mean((x - mean)^2), (x - mean) *
    rsqrt(var + eps) * scale + bias -- cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the last axis with affine parameters: x [..., D]
    (any D), scale and bias [D] -> x's shape and dtype.

    A CPU tensor takes ``layer_norm_reference``.  A CUDA tensor launches
    kernel K7 (``csrc/layer_norm.cu``) on the current stream without
    synchronising, or raises for what it does not take.  A view that is
    contiguous but not 16-byte aligned (or a D the vector loads do not
    divide) takes the kernel's generic path.
    """
    D = x.shape[-1]
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"layer_norm: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} are not [{D}]")
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"layer_norm: dtype {x.dtype} (kernel takes float32 "
                        "or bfloat16)")
    if not x.is_contiguous():
        raise ValueError("layer_norm: x must be contiguous")
    g, b = (t.to(device=x.device, dtype=torch.float32).contiguous()
            for t in (scale, bias))
    out = torch.empty_like(x)
    rc = _build.kernels().layer_norm_launch(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
        x.numel() // D, D, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "layer_norm")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
