"""Vision Transformer (DINOv2 family) as a torch ``nn.Module``.

Counterpart of ``bsc_nav_tpu/models/vit.py``: registers, layerscale,
tanh-GELU (``gelu_exact`` for the erf form), swiglu, and the same
``forward_features`` keys.  Parameters keep the JAX package's layout and
names -- linear weights are ``w [fan_in, fan_out]`` -- so a module's
``state_dict`` keys are exactly the dotted keys ``save_params_npz``
writes (``blocks.3.qkv.w``).  Attention runs through
``ops.flash_attention.attention_from_qkv`` (kernel K1 on the card).

Resizes (``preprocess``, ``interpolate_pos_embed``) reproduce
``jax.image.resize``: a separable resampling matrix per axis, built in
numpy exactly as JAX builds it (triangle or Keys a = -0.5 cubic kernel,
widened when downsampling, i.e. antialiased, weights renormalized at the
edges), applied with a matmul.  torch's ``F.interpolate`` differs at the
edges and, without antialias, in its cubic coefficient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.ops.flash_attention import attention_from_qkv


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 14
    dim: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: float = 4.0
    num_registers: int = 4
    layerscale: bool = True
    qkv_bias: bool = True
    ffn: str = "mlp"              # "mlp" | "swiglu"
    ln_eps: float = 1e-6
    gelu_exact: bool = False      # False: tanh-approx GELU, as in JAX

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


DINOV2_VITS14_REG = ViTConfig(dim=384, depth=12, heads=6)
DINOV2_VITB14_REG = ViTConfig(dim=768, depth=12, heads=12)
DINOV2_VITL14_REG = ViTConfig(dim=1024, depth=24, heads=16)
DINOV2_VITG14_REG = ViTConfig(dim=1536, depth=40, heads=24, ffn="swiglu")

CONFIGS = {
    "dinov2_vits14_reg": DINOV2_VITS14_REG,
    "dinov2_vitb14_reg": DINOV2_VITB14_REG,
    "dinov2_vitl14_reg": DINOV2_VITL14_REG,
    "dinov2_vitg14_reg": DINOV2_VITG14_REG,
}


# --------------------------------------------------------------------------
# resampling (jax.image.resize semantics)
# --------------------------------------------------------------------------

def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[in_size, out_size] float32 resampling matrix of
    ``jax.image.resize(..., method, antialias=True)`` along one axis."""
    f = np.float32
    inv_scale = f(1.0) / f(out_size / in_size)
    kernel_scale = max(inv_scale, f(1.0))
    sample_f = ((np.arange(out_size, dtype=f) + f(0.5)) * inv_scale
                - f(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f)[:, None])
         / kernel_scale).astype(f)
    w = _KERNELS[method](x).astype(f)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f)


def resize_bhwc(x: torch.Tensor, out_hw, method: str) -> torch.Tensor:
    """[B, H, W, C] float -> [B, oh, ow, C], as jax.image.resize."""
    H, W = x.shape[1], x.shape[2]
    wh = torch.from_numpy(resize_weights(H, out_hw[0], method)).to(
        device=x.device, dtype=x.dtype)
    ww = torch.from_numpy(resize_weights(W, out_hw[1], method)).to(
        device=x.device, dtype=x.dtype)
    return torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(images_uint8: torch.Tensor,
               out_hw: Optional[tuple] = None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalized float32, optionally
    resized (antialiased bilinear)."""
    x = images_uint8.to(torch.float32) / 255.0
    if out_hw is not None and tuple(out_hw) != tuple(images_uint8.shape[1:3]):
        x = resize_bhwc(x, out_hw, "bilinear")
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, T, patch*patch*3] with (ph, pw, c) inner order."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def interpolate_pos_embed(pos: torch.Tensor, grid_hw) -> torch.Tensor:
    """Bicubic (Keys a = -0.5, antialiased) resize of the patch position
    grid to ``grid_hw``; the cls position passes through."""
    gh, gw = grid_hw
    n0 = pos.shape[1] - 1
    if n0 == gh * gw and gh == gw:
        return pos
    g0 = int(round(math.sqrt(n0)))
    grid = pos[:, 1:].reshape(1, g0, g0, -1)
    grid = resize_bhwc(grid.to(torch.float32), (gh, gw), "bicubic")
    return torch.cat([pos[:, :1],
                      grid.reshape(1, gh * gw, -1).to(pos.dtype)], dim=1)


# --------------------------------------------------------------------------
# modules (parameter names = the JAX params tree)
# --------------------------------------------------------------------------

def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w [fan_in, fan_out]``.  Mixed input and
    parameter dtypes compute in the promoted dtype, as jnp.einsum does;
    the bias is added inside the matmul's accumulator (addmm) before the
    result is cast back to the input dtype."""

    def __init__(self, fan_in, fan_out, bias=True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.w = _param((fan_in, fan_out), dtype, device)
        self.b = _param((fan_out,), dtype, device) if bias else None

    def forward(self, x):
        ct = torch.promote_types(x.dtype, self.w.dtype)
        x2 = x.reshape(-1, x.shape[-1]).to(ct)
        w = self.w.to(ct)
        y = (torch.addmm(self.b.to(ct), x2, w) if self.b is not None
             else x2 @ w)
        return y.reshape(*x.shape[:-1], -1).to(x.dtype)


class LayerNorm(nn.Module):
    """Row LayerNorm with f32 statistics, cast back to the input dtype."""

    def __init__(self, dim, eps, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), dtype, device)
        self.bias = _param((dim,), dtype, device)

    def forward(self, x):
        y = F.layer_norm(x.to(torch.float32), x.shape[-1:],
                         self.scale.to(torch.float32),
                         self.bias.to(torch.float32), self.eps)
        return y.to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.dim
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.cfg = cfg
        self.ln1 = LayerNorm(d, cfg.ln_eps, dtype, device)
        self.qkv = Linear(d, 3 * d, cfg.qkv_bias, dtype, device)
        self.proj = Linear(d, d, True, dtype, device)
        self.ln2 = LayerNorm(d, cfg.ln_eps, dtype, device)
        fc1_out = 2 * hidden if cfg.ffn == "swiglu" else hidden
        self.fc1 = Linear(d, fc1_out, True, dtype, device)
        self.fc2 = Linear(hidden, d, True, dtype, device)
        if cfg.layerscale:
            self.ls1 = _param((d,), dtype, device)
            self.ls2 = _param((d,), dtype, device)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x):
        cfg = self.cfg
        att = attention_from_qkv(self.qkv(self.ln1(x)), heads=cfg.heads)
        att = self.proj(att)
        if self.ls1 is not None:
            att = att * self.ls1.to(att.dtype)
        x = x + att

        y = self.ln2(x)
        if cfg.ffn == "swiglu":
            a, b = self.fc1(y).chunk(2, dim=-1)
            y = self.fc2(F.silu(a) * b)
        else:
            y = self.fc2(F.gelu(self.fc1(y),
                                approximate="none" if cfg.gelu_exact
                                else "tanh"))
        if self.ls2 is not None:
            y = y * self.ls2.to(y.dtype)
        return x + y


class ViT(nn.Module):
    """DINOv2-style encoder.  Parameters are created empty; fill them with
    ``init_params`` or the loaders in ``models.weights``."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device="cpu"):
        super().__init__()
        dev = resolve_device(device)
        d = cfg.dim
        self.cfg = cfg
        self.patch_embed = Linear(cfg.patch_size ** 2 * 3, d, True, dtype,
                                  dev)
        self.cls_token = _param((1, 1, d), dtype, dev)
        self.pos_embed = _param((1, 1 + cfg.num_patches, d), dtype, dev)
        self.reg_token = (_param((1, cfg.num_registers, d), dtype, dev)
                          if cfg.num_registers else None)
        self.norm = LayerNorm(d, cfg.ln_eps, dtype, dev)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype, dev) for _ in range(cfg.depth))

    @torch.no_grad()
    def forward_features(self, images: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
        """images: [B, H, W, 3] normalized float (its dtype is the compute
        dtype).  Returns x_norm_clstoken, x_norm_regtokens and
        x_norm_patchtokens."""
        cfg = self.cfg
        B, H, W, _ = images.shape
        grid_hw = (H // cfg.patch_size, W // cfg.patch_size)

        x = self.patch_embed(patchify(images, cfg.patch_size))
        cls = self.cls_token.to(x.dtype).expand(B, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, grid_hw).to(x.dtype)

        n_reg = cfg.num_registers
        if n_reg:
            reg = self.reg_token.to(x.dtype).expand(B, n_reg, cfg.dim)
            x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)

        for blk in self.blocks:
            x = blk(x)

        x = self.norm(x)
        return {
            "x_norm_clstoken": x[:, 0],
            "x_norm_regtokens": x[:, 1:1 + n_reg],
            "x_norm_patchtokens": x[:, 1 + n_reg:],
        }


@torch.no_grad()
def init_params(cfg: ViTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> ViT:
    """A randomly initialized ViT, with the JAX package's distributions
    (linear weights N(0, 1/fan_in), zero biases, unit LayerNorms,
    layerscale 1e-5, tokens N(0, 0.02^2)).  Draws come from ``generator``,
    which must live on ``device``; they do not reproduce jax.random."""
    model = ViT(cfg, dtype=dtype, device=device)

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32).mul_(std))

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w":
            normal_(p, 1.0 / math.sqrt(p.shape[0]))
        elif leaf in ("b", "bias"):
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("ls1", "ls2"):
            p.fill_(1e-5)
        else:                       # cls_token, pos_embed, reg_token
            normal_(p, 0.02)
    return model
