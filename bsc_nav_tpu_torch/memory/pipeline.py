"""The two device pipelines of the memory spine.

Counterpart of ``bsc_nav_tpu/memory/pipeline.py``:

  build_step: RGB-D frames + poses -> DINOv2 patch tokens -> voxel ingest
  query_step: query images -> pooled token -> store scan -> top-K voxels

PyTorch runs eagerly, so each "step" is a plain function; kernels are
queued on the current CUDA stream and nothing synchronises until a caller
reads a result.  The carry is ``(state, generator)``; the state is
updated in place.  The text-query, pooled-query and batched-query steps
are queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import torch

from bsc_nav_tpu.config import Config
from bsc_nav_tpu_torch.memory.ingest import ingest_frames
from bsc_nav_tpu_torch.memory.query import gaussian_center_pool, localize
from bsc_nav_tpu_torch.memory.store import VoxelStoreState
from bsc_nav_tpu_torch.models import vit


def encode_patch_grid(params: vit.ViT, images_uint8: torch.Tensor,
                      vit_cfg: vit.ViTConfig, cfg: Config,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> patch-token grid [B, nh, nw, D]:
    resize to the query resolution, ImageNet-normalize, ViT forward."""
    q = (cfg.query.query_height, cfg.query.query_width)
    x = vit.preprocess(images_uint8, out_hw=q).to(compute_dtype)
    feats = params.forward_features(x)["x_norm_patchtokens"]
    B = images_uint8.shape[0]
    return feats.reshape(B, q[0] // vit_cfg.patch_size,
                         q[1] // vit_cfg.patch_size, -1)


def make_build_step(cfg: Config, vit_cfg: vit.ViTConfig,
                    compute_dtype=torch.float32):
    """Returns (carry, params, rgb, depth, poses, pix=None, repl_idx=None)
    -> (carry, stats) with carry = (state, generator).  ``pix`` and
    ``repl_idx`` inject the ingest's random draws (see ingest_frames)."""

    def build_step(carry, params: vit.ViT, rgb, depth, poses,
                   pix: Optional[torch.Tensor] = None,
                   repl_idx: Optional[torch.Tensor] = None):
        state, generator = carry
        patch = encode_patch_grid(params, rgb, vit_cfg, cfg, compute_dtype)
        state, stats = ingest_frames(
            state, rgb, depth, poses, patch.to(torch.float32), generator,
            cfg, pix=pix, repl_idx=repl_idx)
        return (state, generator), stats

    return build_step


def make_query_step(cfg: Config, vit_cfg: vit.ViTConfig,
                    compute_dtype=torch.float32):
    """Returns (state, params, query_images_uint8, top_k, masks...) ->
    (positions [top_k, 3], scores [top_k])."""

    def query_step(state: VoxelStoreState, params: vit.ViT, images_uint8,
                   top_k: int = 100,
                   use_region: bool = False,
                   curr_grid: Optional[torch.Tensor] = None,
                   region_radius: float = 0.0,
                   use_floor: bool = False,
                   floor_range: Optional[torch.Tensor] = None):
        q = (cfg.query.query_height, cfg.query.query_width)
        x = vit.preprocess(images_uint8, out_hw=q).to(compute_dtype)
        tokens = params.forward_features(x)["x_norm_patchtokens"]
        pooled = gaussian_center_pool(tokens)
        return localize(
            state, pooled, top_k=top_k, use_region=use_region,
            curr_grid=curr_grid, region_radius=region_radius,
            use_floor=use_floor, floor_range=floor_range)

    return query_step
