"""VAE decoder: diffusion latents -> RGB images.

Counterpart of ``bsc_nav_tpu/models/vae.py``: the SD3-family decoder --
conv-in, middle (resnet / single-head attention / resnet), up-stages of
resnet blocks with nearest-neighbour upsampling, group norm + SiLU +
conv-out.  Parameters are a plain dict tree in the JAX layout (conv
weights HWIO ``[kh, kw, cin, cout]``), activations NHWC at the public
functions, as there.

The convolutions go to cuDNN (``F.conv2d`` on an NCHW view of the NHWC
tensor, i.e. channels-last memory); a caller that wants them in full f32
sets ``torch.backends.cudnn.allow_tf32 = False``.  The group norm keeps
the JAX package's centered two-pass variance (``vae.py:103-139``):
``F.group_norm``'s one-pass form cancels catastrophically for groups of
low variance and large mean.  The mid attention is an einsum there, not a
kernel, so it is matmuls here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from bsc_nav_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 16
    base_channels: int = 128
    channel_mults: tuple = (1, 2, 4, 4)
    blocks_per_stage: int = 3       # decoder uses layers_per_block + 1
    groups: int = 32
    scaling_factor: float = 1.5305  # SD3 latent scaling
    shift_factor: float = 0.0609


SD3_VAE = VAEConfig()
VAE_TEST = VAEConfig(latent_channels=4, base_channels=16,
                     channel_mults=(1, 2), blocks_per_stage=2, groups=4,
                     scaling_factor=1.0, shift_factor=0.0)


@torch.no_grad()
def init_params(cfg: VAEConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Random weights with the JAX package's distributions (``vae.py:42-92``:
    conv weights N(0, 1/fan_in), zero biases, unit group norms).
    ``generator`` must live on ``device``; the draws do not reproduce
    jax.random."""
    dev = resolve_device(device)
    chans = [cfg.base_channels * m for m in cfg.channel_mults]
    top = chans[-1]

    def conv(kh, kw, cin, cout):
        w = torch.randn((kh, kw, cin, cout), generator=generator, device=dev,
                        dtype=torch.float32) / math.sqrt(kh * kw * cin)
        return {"w": w.to(dtype),
                "b": torch.zeros(cout, dtype=dtype, device=dev)}

    def gn(c):
        return {"scale": torch.ones(c, dtype=dtype, device=dev),
                "bias": torch.zeros(c, dtype=dtype, device=dev)}

    def resnet(cin, cout):
        p = {"gn1": gn(cin), "conv1": conv(3, 3, cin, cout),
             "gn2": gn(cout), "conv2": conv(3, 3, cout, cout)}
        if cin != cout:
            p["skip"] = conv(1, 1, cin, cout)
        return p

    params: Dict[str, Any] = {
        "conv_in": conv(3, 3, cfg.latent_channels, top),
        "mid_res1": resnet(top, top),
        "mid_attn": {"gn": gn(top), "q": conv(1, 1, top, top),
                     "k": conv(1, 1, top, top), "v": conv(1, 1, top, top),
                     "o": conv(1, 1, top, top)},
        "mid_res2": resnet(top, top),
        "stages": [],
        "gn_out": gn(chans[0]),
        "conv_out": conv(3, 3, chans[0], 3),
    }
    cin = top
    for cout in reversed(chans):
        stage: Dict[str, Any] = {"res": []}
        for _ in range(cfg.blocks_per_stage):
            stage["res"].append(resnet(cin, cout))
            cin = cout
        stage["upconv"] = conv(3, 3, cout, cout)
        params["stages"].append(stage)
    params["stages"][-1].pop("upconv")   # the last stage does not upsample
    return params


def _conv(x, p):
    """NHWC 'SAME' stride-1 conv with HWIO weights, in x's dtype."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)           # [cout, cin, kh, kw]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["b"].to(x.dtype),
                 padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _group_norm(x, p, groups):
    """Group norm with f32 statistics and a centered second pass
    (``vae.py:103-139``)."""
    B, H, W, C = x.shape
    g = min(groups, C)
    cg = C // g
    xf = x.to(torch.float32)
    n = H * W * cg
    mu = xf.sum(dim=(1, 2)).reshape(B, g, cg).sum(-1) / n          # [B, g]
    mu_c = mu.repeat_interleave(cg, dim=-1)                        # [B, C]
    d = xf - mu_c[:, None, None, :]
    var = (d * d).sum(dim=(1, 2)).reshape(B, g, cg).sum(-1) / n    # >= 0
    scale = (torch.rsqrt(var + 1e-6).repeat_interleave(cg, dim=-1)
             * p["scale"].to(torch.float32)[None])
    bias = p["bias"].to(torch.float32)[None] - mu_c * scale
    return (xf * scale[:, None, None, :] + bias[:, None, None, :]).to(x.dtype)


def _resnet(x, p, groups):
    h = _conv(F.silu(_group_norm(x, p["gn1"], groups)), p["conv1"])
    h = _conv(F.silu(_group_norm(h, p["gn2"], groups)), p["conv2"])
    if "skip" in p:
        x = _conv(x, p["skip"])
    return x + h


def _mid_attention(x, p, groups):
    B, H, W, C = x.shape
    h = _group_norm(x, p["gn"], groups)
    q, k, v = (_conv(h, p[n]).reshape(B, H * W, C) for n in ("q", "k", "v"))
    att = torch.softmax(q.float() @ k.float().transpose(1, 2)
                        / math.sqrt(C), dim=-1)
    out = (att.to(v.dtype).float() @ v.float()).to(x.dtype)
    return x + _conv(out.reshape(B, H, W, C), p["o"])


def _upsample(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


@torch.no_grad()
def decode(params, latents: torch.Tensor, cfg: VAEConfig) -> torch.Tensor:
    """latents [B, h, w, latent_channels] -> RGB in [-1, 1]
    [B, h * 2^(stages-1), ..., 3], in the latents' dtype."""
    x = latents / cfg.scaling_factor + cfg.shift_factor
    x = _conv(x, params["conv_in"])
    x = _resnet(x, params["mid_res1"], cfg.groups)
    x = _mid_attention(x, params["mid_attn"], cfg.groups)
    x = _resnet(x, params["mid_res2"], cfg.groups)
    for stage in params["stages"]:
        for res in stage["res"]:
            x = _resnet(x, res, cfg.groups)
        if "upconv" in stage:
            x = _conv(_upsample(x), stage["upconv"])
    x = F.silu(_group_norm(x, params["gn_out"], cfg.groups))
    return _conv(x, params["conv_out"])


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] floats -> uint8, computed in f32 (truncating, as
    ``astype(uint8)``)."""
    return ((images.to(torch.float32) + 1.0) * 127.5).clamp(0, 255).to(
        torch.uint8)
