"""Query-side localization: pooled query feature -> top-K goal voxels.

Counterpart of ``bsc_nav_tpu/memory/query.py``: cosine scan over every
stored token (kernel K2 on the card), per-voxel max, region and floor
masks, top-K; ``localize_batch`` localizes Q queries in one pass over the
store (K2's Q-query form), with a region radius per query.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bsc_nav_tpu_torch.memory.store import VoxelStoreState
from bsc_nav_tpu_torch.ops.similarity import (
    max_cosine, max_cosine_per_voxel_batch)


def gaussian_center_pool(tokens: torch.Tensor) -> torch.Tensor:
    """Pool patch tokens [B, T, D] (T a square patch grid) with a
    center-weighted Gaussian, then average across query images -> [D]."""
    B, T, D = tokens.shape
    g = int(round(T ** 0.5))
    if g * g != T:
        raise ValueError(f"token count {T} is not a square patch grid")
    ar = torch.arange(g, dtype=torch.float32, device=tokens.device)
    xs, ys = ar.repeat(g), ar.repeat_interleave(g)
    center = (g - 1) / 2.0
    d2 = (xs - center) ** 2 + (ys - center) ** 2
    w = torch.exp(-d2 / (2.0 * (g / 2.0) ** 2))
    w = w / w.sum()
    pooled = torch.einsum("btd,t->bd", tokens.to(torch.float32), w)
    return pooled.mean(dim=0)


def localize(
    state: VoxelStoreState,
    query: torch.Tensor,                       # [D] pooled query feature
    top_k: int = 100,
    use_region: bool = False,
    curr_grid: Optional[torch.Tensor] = None,  # [3] int (r, c, h)
    region_radius: float = 0.0,
    use_floor: bool = False,
    floor_range: Optional[torch.Tensor] = None,  # [2] int (min_h, max_h)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K most query-similar voxels: (positions [top_k, 3] int32,
    scores [top_k] f32).  Padding entries (fewer live voxels than top_k)
    score -inf; their positions are ``slot_pos`` of whatever slot topk
    picked, as in the JAX version."""
    V1 = state.feat_count.shape[0]
    dev = state.feats.device
    qn = query.to(torch.float32)
    qn = qn / torch.linalg.norm(qn).clamp_min(1e-12)

    per_voxel = max_cosine(state.feats, state.feat_norm, state.feat_count,
                           qn)                                   # [V1]

    mask = torch.arange(V1, device=dev) < state.num_voxels
    if use_region:
        d2 = ((state.slot_pos.to(torch.float32)
               - curr_grid.to(device=dev, dtype=torch.float32)[None, :]) ** 2
              ).sum(dim=-1)
        mask &= d2 <= region_radius * region_radius
    if use_floor:
        h = state.slot_pos[:, 2]
        fr = floor_range.to(dev)
        mask &= (h >= fr[0]) & (h <= fr[1])

    per_voxel = torch.where(mask, per_voxel,
                            torch.full_like(per_voxel, float("-inf")))
    scores, idx = torch.topk(per_voxel, top_k)
    return state.slot_pos[idx], scores


def localize_batch(
    state: VoxelStoreState,
    queries: torch.Tensor,                       # [Q, D] pooled features
    top_k: int = 100,
    use_floor: bool = False,
    floor_range: Optional[torch.Tensor] = None,  # [2] int (min_h, max_h)
    use_region: bool = False,
    curr_grid: Optional[torch.Tensor] = None,    # [Q, 3] int per query
    region_radii: Optional[torch.Tensor] = None,  # [Q] f32, inf = no mask
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K voxels for every query in one store pass: (positions
    [Q, top_k, 3] int32, scores [Q, top_k] f32).  The single-floor mask
    as in ``localize``, and a region mask per query around its own
    ``curr_grid`` row, an inf radius leaving that query unrestricted (JAX
    ``query.py:102-146``)."""
    V1 = state.feat_count.shape[0]
    dev = state.feats.device
    qn = queries.to(torch.float32)
    qn = qn / torch.linalg.norm(qn, dim=-1, keepdim=True).clamp_min(1e-12)
    per_voxel = max_cosine_per_voxel_batch(
        state.feats, state.feat_norm, state.feat_count,
        qn.contiguous())                                        # [Q, V1]
    mask = (torch.arange(V1, device=dev) < state.num_voxels)[None]
    if use_floor:
        h = state.slot_pos[:, 2]
        fr = floor_range.to(dev)
        mask = mask & ((h >= fr[0]) & (h <= fr[1]))[None]
    if use_region:
        d2 = ((state.slot_pos.to(torch.float32)[None, :, :]
               - curr_grid.to(device=dev, dtype=torch.float32)[:, None, :])
              ** 2).sum(dim=-1)                                 # [Q, V1]
        r2 = region_radii.to(device=dev, dtype=torch.float32).square()[:, None]
        mask = mask & torch.where(torch.isfinite(r2), d2 <= r2,
                                  torch.ones_like(d2, dtype=torch.bool))
    per_voxel = torch.where(mask, per_voxel,
                            torch.full_like(per_voxel, float("-inf")))
    scores, idx = torch.topk(per_voxel, top_k, dim=-1)
    return state.slot_pos[idx], scores
