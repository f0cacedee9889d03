"""Vision Transformer (DINOv2 family) as a torch ``nn.Module``.

Counterpart of ``bsc_nav_tpu/models/vit.py``: registers, layerscale,
tanh-GELU (``gelu_exact`` for the erf form), swiglu, and the same
``forward_features`` keys.  Parameters keep the JAX package's layout and
names -- linear weights are ``w [fan_in, fan_out]`` -- so a module's
``state_dict`` keys are exactly the dotted keys ``save_params_npz``
writes (``blocks.3.qkv.w``).  Attention runs through
``ops.flash_attention.attention_from_qkv`` (kernel K1 on the card); a
model sharded by ``parallel/mesh.shard_vit_params`` runs tensor-parallel
(``forward_features(tp_mesh=)``).

Resizes (``preprocess``, ``interpolate_pos_embed``) reproduce
``jax.image.resize``: a separable resampling matrix per axis, built in
numpy exactly as JAX builds it (triangle or Keys a = -0.5 cubic kernel,
widened when downsampling, i.e. antialiased, weights renormalized at the
edges), applied with a matmul.  torch's ``F.interpolate`` differs at the
edges and, without antialias, in its cubic coefficient.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.ops.flash_attention import (attention_from_qkv,
                                                   attention_from_qkv_tp)
from bsc_nav_tpu_torch.ops.quant import (full_columns, linear_q8,
                                         quantize_weight)


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


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int, method: str,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``resize_weights`` as a tensor on ``device``, built once a key and
    shared by every later call (read-only): a resize then makes no host
    work and no copy to the device, so that it can be captured in a CUDA
    graph."""
    return torch.from_numpy(resize_weights(in_size, out_size, method)).to(
        device=device, dtype=dtype)


def resize_bhwc(x: torch.Tensor, out_hw, method: str) -> torch.Tensor:
    """[B, H, W, C] float -> [B, oh, ow, C], as jax.image.resize."""
    H, W = x.shape[1], x.shape[2]
    wh = resize_matrix(H, out_hw[0], method, x.dtype, x.device)
    ww = resize_matrix(W, out_hw[1], method, x.dtype, x.device)
    return torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=8)
def imagenet_stats(device: torch.device) -> tuple:
    """(mean, std) float32 [3] on ``device``, built once a device."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (IMAGENET_MEAN, IMAGENET_STD))


def preprocess(images_uint8: torch.Tensor,
               out_hw: Optional[tuple] = None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalized float32, optionally
    resized (antialiased bilinear).  Its constants are built once
    (``resize_matrix``, ``imagenet_stats``), so nothing inside waits for
    the device."""
    x = images_uint8.to(torch.float32) / 255.0
    if out_hw is not None and tuple(out_hw) != tuple(images_uint8.shape[1:3]):
        x = resize_bhwc(x, out_hw, "bilinear")
    mean, std = imagenet_stats(x.device)
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


_BLOCK_LINEAR = re.compile(r"^blocks\.\d+\.(qkv|proj|fc1|fc2)\.w$")


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
    result is cast back to the input dtype.

    ``quantized=True`` holds the JAX package's int8 leaves instead --
    ``w_q`` int8 [fan_in, fan_out], ``w_s`` f32 [fan_out], ``b`` -- and
    serves them through ``ops.quant.linear_q8``, as JAX's ``_linear``
    does (``vit.py:148-151``).

    ``tp``: the leaf's tensor-parallel split (``parallel/mesh.TPSplit``,
    set by ``shard_vit_params``), None for a whole leaf.  A row-parallel
    leaf takes the whole input or this rank's columns of it and
    all-reduces its product; a column-parallel one returns this rank's
    output columns."""

    def __init__(self, fan_in, fan_out, bias=True, dtype=torch.float32,
                 device=None, quantized=False):
        super().__init__()
        self.tp = None
        if quantized:
            self.w = None
            self.w_q = _param((fan_in, fan_out), torch.int8, device)
            self.w_s = _param((fan_out,), torch.float32, device)
        else:
            self.w = _param((fan_in, fan_out), dtype, device)
            self.w_q = self.w_s = None
        self.b = _param((fan_out,), dtype, device) if bias else None

    def forward(self, x):
        if self.w_q is not None:
            return linear_q8(x, {"w_q": self.w_q, "w_s": self.w_s,
                                 "b": self.b})
        if self.tp is not None and self.tp.kind == "row":
            return self.tp.row_linear(x, self.w, self.b)
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
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None,
                 quantized=False):
        super().__init__()
        d = cfg.dim
        hidden = int(cfg.dim * cfg.mlp_ratio)
        self.cfg = cfg
        self.ln1 = LayerNorm(d, cfg.ln_eps, dtype, device)
        self.qkv = Linear(d, 3 * d, cfg.qkv_bias, dtype, device, quantized)
        self.proj = Linear(d, d, True, dtype, device, quantized)
        self.ln2 = LayerNorm(d, cfg.ln_eps, dtype, device)
        fc1_out = 2 * hidden if cfg.ffn == "swiglu" else hidden
        self.fc1 = Linear(d, fc1_out, True, dtype, device, quantized)
        self.fc2 = Linear(hidden, d, True, dtype, device, quantized)
        if cfg.layerscale:
            self.ls1 = _param((d,), dtype, device)
            self.ls2 = _param((d,), dtype, device)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x, tp_mesh=None):
        """One block (JAX ``vit.py:190-225``).  With ``tp_mesh`` and a
        head-blocked column-parallel qkv whose heads split over mp, the
        rank's heads attend with no collective; a column-parallel qkv
        otherwise is all-gathered and the whole attention runs (GSPMD's
        path).  The row-parallel proj and fc2 take either form."""
        cfg = self.cfg
        qkv = self.qkv(self.ln1(x))
        tp = self.qkv.tp
        if (tp_mesh is not None and tp_mesh.mp > 1 and tp is not None
                and tp.perm is not None and cfg.heads % tp_mesh.mp == 0):
            att = attention_from_qkv_tp(qkv, heads=cfg.heads, mesh=tp_mesh)
        else:
            att = attention_from_qkv(full_columns(qkv, tp), heads=cfg.heads)
        att = self.proj(att)
        if self.ls1 is not None:
            att = att * self.ls1.to(att.dtype)
        x = x + att

        h = self.fc1(self.ln2(x))
        if cfg.ffn == "swiglu":
            # a rank's fc1 columns do not pair swiglu's (a, b) halves
            a, b = full_columns(h, self.fc1.tp).chunk(2, dim=-1)
            y = self.fc2(F.silu(a) * b)
        else:
            y = self.fc2(F.gelu(h, approximate="none" if cfg.gelu_exact
                                else "tanh"))
        if self.ls2 is not None:
            y = y * self.ls2.to(y.dtype)
        return x + y


class GraphCache(dict):
    """CUDA graphs captured over a model's forward, under their caller's
    key (``memory/pipeline.encode_patch_grid``).  A copy of the model
    starts with none, since a graph reads the storage it was captured on."""

    def __deepcopy__(self, memo):
        return type(self)()

    def __reduce__(self):
        return type(self), ()


class ViT(nn.Module):
    """DINOv2-style encoder.  Parameters are created empty; fill them with
    ``init_params`` or the loaders in ``models.weights``.  ``quantized``
    makes every block's qkv / proj / fc1 / fc2 an int8 leaf
    (``quantize_params``).  ``graphs`` holds the CUDA graphs of its
    encodes, which die with the model."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device="cuda",
                 quantized: bool = False):
        super().__init__()
        dev = resolve_device(device)
        d = cfg.dim
        self.cfg = cfg
        self.quantized = quantized
        self.patch_embed = Linear(cfg.patch_size ** 2 * 3, d, True, dtype,
                                  dev)
        self.cls_token = _param((1, 1, d), dtype, dev)
        self.pos_embed = _param((1, 1 + cfg.num_patches, d), dtype, dev)
        self.reg_token = (_param((1, cfg.num_registers, d), dtype, dev)
                          if cfg.num_registers else None)
        self.norm = LayerNorm(d, cfg.ln_eps, dtype, dev)
        self.blocks = nn.ModuleList(
            Block(cfg, dtype, dev, quantized) for _ in range(cfg.depth))
        self.graphs = GraphCache()

    @torch.no_grad()
    def forward_features(self, images: torch.Tensor, tp_mesh=None
                         ) -> Dict[str, torch.Tensor]:
        """images: [B, H, W, 3] normalized float (its dtype is the compute
        dtype).  Returns x_norm_clstoken, x_norm_regtokens and
        x_norm_patchtokens.  ``tp_mesh``: the mesh of a model sharded by
        ``parallel/mesh.shard_vit_params(..., tp_qkv_layout=True)``, whose
        blocks then attend per rank (JAX ``vit.py:228-263``)."""
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
            x = blk(x, tp_mesh=tp_mesh)

        x = self.norm(x)
        return {
            "x_norm_clstoken": x[:, 0],
            "x_norm_regtokens": x[:, 1:1 + n_reg],
            "x_norm_patchtokens": x[:, 1 + n_reg:],
        }


@torch.no_grad()
def init_params(cfg: ViTConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> ViT:
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


@torch.no_grad()
def quantize_params(model: ViT) -> ViT:
    """A new ViT whose block matmuls (qkv / proj / fc1 / fc2) are int8
    W8A8 leaves served by ``ops.quant.linear_q8`` (JAX ``vit.py:159-
    175``); the patch embedding, layer norms, layer scales and tokens are
    copied as they are.  ``model`` is left unchanged."""
    if model.quantized:
        raise ValueError("quantize_params: model is already quantized")
    out = ViT(model.cfg, dtype=model.cls_token.dtype,
              device=model.cls_token.device, quantized=True)
    sd = {}
    for name, t in model.state_dict().items():
        if _BLOCK_LINEAR.match(name):
            q = quantize_weight({"w": t})
            sd[name + "_q"], sd[name + "_s"] = q["w_q"], q["w_s"]
        else:
            sd[name] = t
    out.load_state_dict(sd, strict=True)
    return out
