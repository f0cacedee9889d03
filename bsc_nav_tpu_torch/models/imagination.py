"""Text -> query-image "imagination": the SD3.5-medium pipeline behind a
text goal.

Counterpart of ``bsc_nav_tpu/models/imagination.py``: the reference's
``imaginary`` (3 images, 512^2, 28 steps, CFG 7.0) with the conditioning
of diffusers' ``StableDiffusion3Pipeline.encode_prompt``:

  pooled  = concat(CLIP-L pooled 768, CLIP-G pooled 1280)      -> 2048
  context = concat(CLIP-L hidden[-2], CLIP-G hidden[-2])        -> 2048
            zero-padded to the 4096 joint width, then the T5-XXL
            sequence features appended along the sequence axis (a zero
            block of the CLIP length when T5 is absent).

PyTorch runs eagerly, so the weights stay on this object and
``imagine_core`` takes only the prompt's ids and the initial noise; the
JAX package passes both as jit arguments.  Its own noise comes from a
``torch.Generator`` seeded with ``seed`` (``next_noise``), which does not
reproduce jax.random; a test injects the JAX package's draw instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bsc_nav_tpu_torch.models import clip as C
from bsc_nav_tpu_torch.models import mmdit as M
from bsc_nav_tpu_torch.models import t5 as T5
from bsc_nav_tpu_torch.models import tokenizer as T
from bsc_nav_tpu_torch.models import vae as V


@dataclasses.dataclass
class DiffusionImagination:
    """Callable matching the VoxelTokenMemory imagination protocol:
    ``imagination(text) -> uint8 [num_images, H, W, 3]``.  The MMDiT, VAE
    and T5 trees and the two CLIP text towers (``clip.TextTower``) must
    live on one device, which is where the pipeline runs."""

    mmdit_params: dict
    mmdit_cfg: M.MMDiTConfig
    vae_params: dict
    vae_cfg: V.VAEConfig
    clip_l_params: C.TextTower
    clip_l_cfg: C.CLIPConfig
    clip_g_params: C.TextTower
    clip_g_cfg: C.CLIPConfig
    tokenizer: object
    # SD3.5's two CLIP tokenizers differ only in the pad token (L pads with
    # <|endoftext|>, G with id 0); one instance serves both
    tokenizer_g: Optional[object] = None
    num_images: int = 3
    num_steps: int = 28
    guidance_scale: float = 7.0
    seed: int = 0
    # optional T5 conditioning; None appends a zero block (diffusers'
    # text_encoder_3=None)
    t5_params: Optional[dict] = None
    t5_cfg: Optional[T5.T5Config] = None
    t5_tokenizer: Optional[object] = None
    # the reference's imaginary() passes max_sequence_length=512
    t5_seq_len: int = 512
    # int8 W8A8 on the MMDiT token matmuls (``cfg.models.diffusion_int8``)
    quantize: bool = False

    def __post_init__(self):
        if self.quantize:
            self.mmdit_params = M.quantize_params(self.mmdit_params)
        if self.tokenizer_g is None:
            self.tokenizer_g = self.tokenizer
        lcfg, gcfg, mcfg = self.clip_l_cfg, self.clip_g_cfg, self.mmdit_cfg
        if lcfg.embed_dim + gcfg.embed_dim != mcfg.pooled_dim:
            raise ValueError(
                "pooled concat width must equal the MMDiT pooled_dim "
                f"({lcfg.embed_dim}+{gcfg.embed_dim} != {mcfg.pooled_dim})")
        if (lcfg.text_width + gcfg.text_width > mcfg.context_dim
                or lcfg.context_length != gcfg.context_length):
            raise ValueError("the CLIP towers do not fit the MMDiT context")
        self.device = self.clip_l_params.pos_embed.device
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)

    @property
    def use_t5(self) -> bool:
        return self.t5_params is not None

    @torch.no_grad()
    def encode_conditioning(self, ids: torch.Tensor, t5_ids: torch.Tensor):
        """(context [B, 77 + S_t5, context_dim], pooled [B, pooled_dim]) for
        ids [2, B, 77] (row 0 for the L tower, row 1 for G)."""
        hl, pl = C.encode_text_sd3(self.clip_l_params, ids[0], self.clip_l_cfg)
        hg, pg = C.encode_text_sd3(self.clip_g_params, ids[1], self.clip_g_cfg)
        pooled = torch.cat([pl, pg], dim=-1)
        clip_ctx = torch.cat([hl, hg], dim=-1)
        clip_ctx = F.pad(clip_ctx, (0, self.mmdit_cfg.context_dim
                                    - clip_ctx.shape[-1]))
        if self.use_t5:
            t5_ctx = T5.encode(self.t5_params, t5_ids, self.t5_cfg)
        else:
            t5_ctx = torch.zeros_like(clip_ctx)
        return (torch.cat([clip_ctx, t5_ctx.to(clip_ctx.dtype)], dim=1),
                pooled)

    @torch.no_grad()
    def imagine_core(self, ids, ids_uncond, t5_ids, t5_ids_uncond,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Conditioning, CFG sampling and VAE decode: uint8 images
        [num_images, H, W, 3] on the device.  ``noise`` [num_images, h, w,
        C] is the sampler's initial draw (``next_noise`` when None)."""
        ctx, pool = self.encode_conditioning(ids, t5_ids)
        ctx_u, pool_u = self.encode_conditioning(ids_uncond, t5_ids_uncond)
        n = self.num_images

        def rep(a):
            return a.repeat_interleave(n, dim=0)

        lat = M.sample(self.mmdit_params, rep(ctx), rep(pool), self.mmdit_cfg,
                       num_steps=self.num_steps,
                       guidance_scale=self.guidance_scale,
                       context_uncond=rep(ctx_u), pooled_uncond=rep(pool_u),
                       noise=self.next_noise() if noise is None else noise)
        img = V.decode(self.vae_params, lat.to(ctx.dtype), self.vae_cfg)
        return V.to_uint8(img)

    def next_noise(self) -> torch.Tensor:
        """The next initial noise [num_images, h, w, C] f32 from this
        imagination's generator."""
        c = self.mmdit_cfg
        return torch.randn(
            (self.num_images, c.input_size, c.input_size, c.in_channels),
            generator=self.generator, device=self.device)

    def prep_inputs(self, text: str):
        """Host tokenization of one prompt -> (ids, ids_uncond, t5_ids,
        t5_ids_uncond) on the device; ids are [2, 1, 77]: row 0 for the L
        tower (pads with <|endoftext|>), row 1 for G (pads 0)."""
        def stack(t):
            l = T.tokenize([t], self.tokenizer, pad_id=self.tokenizer.eot)
            g = T.tokenize([t], self.tokenizer_g)
            return torch.from_numpy(np.stack([l, g])).to(self.device)
        return (stack(text), stack(""),
                self._t5_ids(text), self._t5_ids(""))

    def _t5_ids(self, text: str) -> torch.Tensor:
        if not self.use_t5:
            return torch.zeros((1, 1), dtype=torch.int32,
                               device=self.device)    # unused placeholder
        ids = self.t5_tokenizer.encode(text)
        L = self.t5_seq_len
        # HF T5 truncation keeps </s> as the last token when the prompt
        # fills the window; pad with 0 otherwise
        ids = (ids[:L - 1] + [1] + [0] * L)[:L]
        return torch.tensor([ids], dtype=torch.int32, device=self.device)

    def __call__(self, text: str) -> np.ndarray:
        return self.imagine_core(*self.prep_inputs(text)).cpu().numpy()
