"""CLIP dual towers (image + text) as torch ``nn.Module``s.

Counterpart of ``bsc_nav_tpu/models/clip.py``: the open_clip layout
(pre-LN transformer, class embedding, ln_pre / ln_post, linear
projections; a causal text tower pooled at the first arg-max token id),
quick-GELU, tanh- or erf-GELU, and the SD3 text-encoder output.  Parameter
names follow the JAX params tree, so ``CLIP.state_dict()`` keys are the
dotted keys ``save_params_npz`` writes (``visual.blocks.3.qkv.w``), and a
tower quantized by ``quantize_params`` holds the same ``w_q`` / ``w_s``
leaves as the JAX package's.

Attention runs through ``ops.flash_attention.attention_from_qkv``: at
MetaCLIP ViT-H's head_dim 80 and in the causal text towers that is kernel
K3 ``short_attention`` on the card.  The checkpoint converters stay in the
JAX package; the port reads their ``.npz`` output
(``models.weights.load_clip_npz``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Iterable

import torch
import torch.nn.functional as F
from torch import nn

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.models.vit import (
    LayerNorm, Linear, _param, patchify, resize_bhwc)
from bsc_nav_tpu_torch.ops.flash_attention import attention_from_qkv
from bsc_nav_tpu_torch.ops.quant import quantize_weight


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """The JAX package's ``CLIPConfig`` (``clip.py:29-54``), field for
    field: that module imports JAX, so the dataclass is redefined."""

    embed_dim: int = 1024
    # image tower
    image_size: int = 224
    patch_size: int = 14
    vision_width: int = 1280
    vision_layers: int = 32
    vision_heads: int = 16
    # text tower
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 1024
    text_heads: int = 16
    text_layers: int = 24
    ln_eps: float = 1e-5
    gelu_exact: bool = False      # False: tanh-approx GELU
    quick_gelu: bool = False      # x * sigmoid(1.702 x); overrides gelu_exact

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


# MetaCLIP ViT-H/14 as published (open_clip ``ViT-H-14-quickgelu``, HF
# ``hidden_act: quick_gelu``); the JAX package's preset states the tanh
# form, a deliberate divergence.  The detector and ``CLIPMatcher`` follow it.
METACLIP_VITH14 = CLIPConfig(quick_gelu=True)
CLIP_VITB32_TEST = CLIPConfig(
    embed_dim=64, image_size=32, patch_size=8, vision_width=96,
    vision_layers=2, vision_heads=3, context_length=16, vocab_size=512,
    text_width=64, text_heads=4, text_layers=2)
SD3_CLIP_L = CLIPConfig(embed_dim=768, text_width=768, text_heads=12,
                        text_layers=12, quick_gelu=True)
SD3_CLIP_G = CLIPConfig(embed_dim=1280, text_width=1280, text_heads=20,
                        text_layers=32)
SD3_CLIP_L_TEST = CLIPConfig(embed_dim=6, text_width=8, text_heads=2,
                             text_layers=2, context_length=16,
                             vocab_size=512, quick_gelu=True)
SD3_CLIP_G_TEST = CLIPConfig(embed_dim=10, text_width=16, text_heads=2,
                             text_layers=3, context_length=16,
                             vocab_size=512)

CONFIGS = {"metaclip_vith14": METACLIP_VITH14,
           "sd3_clip_l": SD3_CLIP_L,
           "sd3_clip_g": SD3_CLIP_G}

# open_clip image normalization (clip.py:278-279)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


# --------------------------------------------------------------------------
# modules (parameter names = the JAX params tree)
# --------------------------------------------------------------------------

class Block(nn.Module):
    """Pre-LN residual attention block: ln1, qkv, proj, ln2, fc1, fc2."""

    def __init__(self, width, eps, dtype, device, quantized=False):
        super().__init__()
        self.ln1 = LayerNorm(width, eps, dtype, device)
        self.qkv = Linear(width, 3 * width, True, dtype, device, quantized)
        self.proj = Linear(width, width, True, dtype, device, quantized)
        self.ln2 = LayerNorm(width, eps, dtype, device)
        self.fc1 = Linear(width, 4 * width, True, dtype, device, quantized)
        self.fc2 = Linear(4 * width, width, True, dtype, device, quantized)


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype, device, quantized=False):
        super().__init__()
        w, p = cfg.vision_width, cfg.patch_size
        self.patch_embed = Linear(p * p * 3, w, False, dtype, device)
        self.class_embedding = _param((w,), dtype, device)
        self.pos_embed = _param((cfg.grid ** 2 + 1, w), dtype, device)
        self.ln_pre = LayerNorm(w, cfg.ln_eps, dtype, device)
        self.blocks = nn.ModuleList(
            Block(w, cfg.ln_eps, dtype, device, quantized)
            for _ in range(cfg.vision_layers))
        self.ln_post = LayerNorm(w, cfg.ln_eps, dtype, device)
        self.proj = _param((w, cfg.embed_dim), dtype, device)


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, dtype, device, quantized=False):
        super().__init__()
        w = cfg.text_width
        self.token_embedding = _param((cfg.vocab_size, w), dtype, device)
        self.pos_embed = _param((cfg.context_length, w), dtype, device)
        self.blocks = nn.ModuleList(
            Block(w, cfg.ln_eps, dtype, device, quantized)
            for _ in range(cfg.text_layers))
        self.ln_final = LayerNorm(w, cfg.ln_eps, dtype, device)
        self.proj = _param((w, cfg.embed_dim), dtype, device)


class CLIP(nn.Module):
    """Both towers and ``logit_scale``.  Parameters are created empty; fill
    them with ``init_params`` or the loaders in ``models.weights``.
    ``quantized`` ("none", "visual", "text" or "both") names the towers
    whose block matmuls hold int8 leaves."""

    def __init__(self, cfg: CLIPConfig, dtype=torch.float32, device="cuda",
                 quantized: str = "none"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.quantized = quantized
        self.visual = VisionTower(cfg, dtype, dev,
                                  quantized in ("visual", "both"))
        self.text = TextTower(cfg, dtype, dev, quantized in ("text", "both"))
        self.logit_scale = _param((), dtype, dev)

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device


@torch.no_grad()
def _init_(module: nn.Module, generator: torch.Generator):
    """The JAX package's distributions (``clip.py:88-138``); the draws come
    from ``generator`` and do not reproduce jax.random."""

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32).mul_(std))

    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("w", "proj"):           # linears, final projections
            normal_(p, 1.0 / math.sqrt(p.shape[0]))
        elif leaf in ("b", "bias"):
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "logit_scale":
            p.fill_(math.log(1 / 0.07))
        elif leaf == "pos_embed":
            normal_(p, 0.02 if name.startswith("visual.") else 0.01)
        else:                               # class / token embeddings
            normal_(p, 0.02)


def init_params(cfg: CLIPConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> CLIP:
    """A randomly initialized CLIP; ``generator`` must live on ``device``."""
    model = CLIP(cfg, dtype=dtype, device=device)
    _init_(model, generator)
    return model


def init_text_params(cfg: CLIPConfig, generator: torch.Generator,
                     dtype=torch.float32, device="cuda") -> TextTower:
    """A randomly initialized text tower alone (the SD3 conditioning
    towers have no vision side)."""
    tower = TextTower(cfg, dtype, resolve_device(device))
    _init_(tower, generator)
    return tower


_BLOCK_LINEAR = re.compile(r"^(visual|text)\.blocks\.\d+\."
                           r"(qkv|proj|fc1|fc2)\.w$")


@torch.no_grad()
def quantize_params(model: CLIP, towers: str = "both") -> CLIP:
    """A new CLIP whose block matmuls (qkv / proj / fc1 / fc2) in
    ``towers`` ("both", "visual" or "text") are int8 W8A8
    (``clip.py:176-207``); embeddings, layer norms and the final
    projections are copied as they are.  ``model`` is left unchanged."""
    if model.quantized != "none":
        raise ValueError("quantize_params: model is already quantized")
    dtype = model.logit_scale.dtype
    out = CLIP(model.cfg, dtype=dtype, device=model.device, quantized=towers)
    sd = {}
    for name, t in model.state_dict().items():
        m = _BLOCK_LINEAR.match(name)
        if m and towers in (m.group(1), "both"):
            q = quantize_weight({"w": t})
            sd[name + "_q"], sd[name + "_s"] = q["w_q"], q["w_s"]
        else:
            sd[name] = t
    out.load_state_dict(sd, strict=True)
    return out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _tower_forward(x, blocks: Iterable[Block], heads: int, eps: float,
                   causal: bool = False, gelu_exact: bool = False,
                   quick_gelu: bool = False):
    """Pre-LN transformer blocks over [B, S, D] (``eps`` is the blocks'
    own, kept for the JAX signature)."""
    if quick_gelu:
        act = _quick_gelu
    else:
        approx = "none" if gelu_exact else "tanh"

        def act(v):
            return F.gelu(v, approximate=approx)
    for blk in blocks:
        y = blk.ln1(x)
        att = attention_from_qkv(blk.qkv(y), heads=heads, causal=causal)
        x = x + blk.proj(att)
        y = blk.ln2(x)
        x = x + blk.fc2(act(blk.fc1(y)))
    return x


def _normalize(feats):
    return feats / torch.clamp(
        torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-12)


def _project(x, proj):
    """``einsum(..., preferred_element_type=f32)``: an f32 product."""
    return x.to(torch.float32) @ proj.to(torch.float32)


def vision_tokens(visual: VisionTower, images, cfg: CLIPConfig):
    """Patch embed, class token, positions and ln_pre: [B, 1 + T, W]."""
    x = visual.patch_embed(patchify(images, cfg.patch_size))
    B = x.shape[0]
    cls = visual.class_embedding.to(x.dtype).expand(B, 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + visual.pos_embed[None].to(x.dtype)
    return visual.ln_pre(x)


@torch.no_grad()
def encode_image(model: CLIP, images: torch.Tensor, cfg: CLIPConfig,
                 normalize: bool = True) -> torch.Tensor:
    """images: [B, H, W, 3] normalized floats -> [B, embed_dim] f32."""
    v = model.visual
    x = vision_tokens(v, images, cfg)
    x = _tower_forward(x, v.blocks, cfg.vision_heads, cfg.ln_eps,
                       gelu_exact=cfg.gelu_exact, quick_gelu=cfg.quick_gelu)
    feats = _project(v.ln_post(x[:, 0]), v.proj)
    return _normalize(feats) if normalize else feats


def _text_embed(text: TextTower, token_ids: torch.Tensor):
    ids = token_ids.to(device=text.pos_embed.device, dtype=torch.long)
    return text.token_embedding[ids] + text.pos_embed[None], ids


def _pool_eot(x, ids):
    """The row of each sequence's first arg-max token id (EOT has the
    highest id)."""
    eot = torch.argmax(ids, dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), eot]


@torch.no_grad()
def encode_text(model, token_ids: torch.Tensor, cfg: CLIPConfig,
                normalize: bool = True) -> torch.Tensor:
    """token_ids: [B, context_length] int -> [B, embed_dim] f32.  ``model``
    is a CLIP or its text tower alone (``weights.load_clip_text_npz``)."""
    t = model.text if isinstance(model, CLIP) else model
    x, ids = _text_embed(t, token_ids)
    x = _tower_forward(x, t.blocks, cfg.text_heads, cfg.ln_eps, causal=True,
                       gelu_exact=cfg.gelu_exact, quick_gelu=cfg.quick_gelu)
    feats = _project(_pool_eot(t.ln_final(x), ids), t.proj)
    return _normalize(feats) if normalize else feats


@torch.no_grad()
def encode_text_sd3(text: TextTower, token_ids: torch.Tensor,
                    cfg: CLIPConfig) -> tuple:
    """SD3-style text encoding (``clip.py:147-173``): (penultimate hidden
    states [B, S, text_width], without the final LN; the projected pooled
    embedding [B, embed_dim] of the full tower, unnormalized)."""
    x, ids = _text_embed(text, token_ids)
    kw = dict(causal=True, gelu_exact=cfg.gelu_exact,
              quick_gelu=cfg.quick_gelu)
    x = _tower_forward(x, text.blocks[:-1], cfg.text_heads, cfg.ln_eps, **kw)
    penultimate = x
    x = _tower_forward(x, text.blocks[-1:], cfg.text_heads, cfg.ln_eps, **kw)
    pooled = _project(_pool_eot(text.ln_final(x), ids), text.proj)
    return penultimate, pooled.to(x.dtype)


def preprocess(images_uint8: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> open_clip-normalized f32 at image_size,
    resized as ``jax.image.resize`` "bilinear" (antialiased)."""
    x = images_uint8.to(torch.float32) / 255.0
    size = (cfg.image_size, cfg.image_size)
    if tuple(x.shape[1:3]) != size:
        x = resize_bhwc(x, size, "bilinear")
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
