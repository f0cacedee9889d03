"""Query-side localization: pooled query feature -> top-K goal voxels.

Counterpart of ``bsc_nav_tpu/memory/query.py``: cosine scan over every
stored token (kernel K2 on the card), per-voxel max, region and floor
masks, top-K.  ``localize_batch`` (many queries in one store pass) is
queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bsc_nav_tpu_torch.memory.store import VoxelStoreState
from bsc_nav_tpu_torch.ops.similarity import max_cosine


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
