"""Device-resident voxel token store.

Counterpart of ``bsc_nav_tpu/memory/store.py``: the same fields, dtypes
and flat layout.  Token (slot, k) lives at row ``slot*K + k`` of the
[V1*K, D] ``feats`` table; every array carries a trailing garbage row
(slot ``V`` = ``voxel_capacity``, cell ``G*G``, voxel id ``G*G*H``) that
masked scatters write to instead of dropping.  Garbage rows hold
undefined values and are never read as data.

The int8 store (``quantize_feat_rows``, ``quantize_store``) is queued in
ROADMAP.md; ``init_store`` takes float32 and bfloat16 rows.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from bsc_nav_tpu.config import MemoryConfig
from bsc_nav_tpu_torch import resolve_device


@dataclasses.dataclass
class VoxelStoreState:
    """All device-side memory state (V = voxel_capacity, K = cache_size,
    D = token_dim, G = grid_size, H = num_height_cells, V1 = padded
    slot rows).  Ingest updates these tensors in place."""

    # --- token cache, flat [V1*K, D] ---------------------------------------
    feats: torch.Tensor        # [V1*K, D] store dtype
    feat_norm: torch.Tensor    # [V1*K] f32   (||stored token||)
    feat_scale: torch.Tensor   # [1] f32      (int8 dequant scales; unused)
    feat_dist: torch.Tensor    # [V1*K] f32   (squared radial distance)
    feat_count: torch.Tensor   # [V1] int32   (tokens held, <= K)

    # --- per-voxel RGB fusion -------------------------------------------
    rgb_sum: torch.Tensor      # [V1, 3] f32  (sum of alpha * rgb)
    weight: torch.Tensor       # [V1] f32     (sum of alpha)
    slot_pos: torch.Tensor     # [V1, 3] int32 (voxel row, col, h-shifted)

    # --- indexing --------------------------------------------------------
    slot_map: torch.Tensor     # [G*G*H + 1] int32 (voxel id -> slot, -1)
    num_voxels: torch.Tensor   # [] int32
    dropped_voxels: torch.Tensor  # [] int32 (capacity overflow)

    # --- top-down maps -----------------------------------------------------
    cv_map: torch.Tensor       # [G*G + 1, 3] uint8
    max_height: torch.Tensor   # [G*G + 1] int32 (-1 = unobserved)

    # --- surprise-policy statistics (size-1 under the dist policy) -------
    feat_sum: torch.Tensor     # [1, D] f32
    feat_obs: torch.Tensor     # [1] f32

    # --- frame chain -------------------------------------------------------
    inv_init_base_tf: torch.Tensor  # [4, 4] f32
    initialized: torch.Tensor       # [] bool


def linear_voxel_id(rc: torch.Tensor, grid_size: int,
                    num_h: int) -> torch.Tensor:
    """(row, col, h-shifted) -> flat id in [0, G*G*H)."""
    return (rc[..., 0] * grid_size + rc[..., 1]) * num_h + rc[..., 2]


def padded_rows(cfg: MemoryConfig) -> int:
    """Slot-table rows: capacity + garbage row, padded to a multiple of 8
    (the JAX package's mesh divisibility, kept for the same layout)."""
    return ((cfg.voxel_capacity + 1 + 7) // 8) * 8


def init_store(cfg: MemoryConfig, store_dtype=torch.float32,
               device="cpu") -> VoxelStoreState:
    if store_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"store dtype {store_dtype}: the int8 store is queued in "
            "ROADMAP.md; float32 and bfloat16 are ported")
    if cfg.replacement != "dist":
        raise NotImplementedError(
            f"replacement={cfg.replacement!r}: the surprise policy is "
            "queued in ROADMAP.md (Queue 1 item 11)")
    dev = resolve_device(device)
    K, D = cfg.cache_size, cfg.token_dim
    G, H = cfg.grid_size, cfg.num_height_cells
    V1 = padded_rows(cfg)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return VoxelStoreState(
        feats=zeros((V1 * K, D), store_dtype),
        feat_norm=zeros((V1 * K,), torch.float32),
        feat_scale=zeros((1,), torch.float32),
        feat_dist=zeros((V1 * K,), torch.float32),
        feat_count=zeros((V1,), torch.int32),
        rgb_sum=zeros((V1, 3), torch.float32),
        weight=zeros((V1,), torch.float32),
        slot_pos=zeros((V1, 3), torch.int32),
        slot_map=full((G * G * H + 1,), -1, torch.int32),
        num_voxels=zeros((), torch.int32),
        dropped_voxels=zeros((), torch.int32),
        cv_map=zeros((G * G + 1, 3), torch.uint8),
        max_height=full((G * G + 1,), -1, torch.int32),
        feat_sum=zeros((1, D), torch.float32),
        feat_obs=zeros((1,), torch.float32),
        inv_init_base_tf=torch.eye(4, dtype=torch.float32, device=dev),
        initialized=zeros((), torch.bool),
    )


def store_nbytes(cfg: MemoryConfig, store_dtype=torch.float32) -> int:
    """Device footprint of a store with this config, reckoned from its
    shapes (the same sum as the JAX package's)."""
    V, K, D = padded_rows(cfg), cfg.cache_size, cfg.token_dim
    G, H = cfg.grid_size, cfg.num_height_cells
    itemsize = torch.empty((), dtype=store_dtype).element_size()
    return (
        V * K * D * itemsize        # feats (flat layout)
        + V * K * 8                 # feat_norm + feat_dist
        + V * (4 + 12 + 4 + 12)     # count, rgb_sum, weight, slot_pos
        + (G * G * H + 1) * 4       # slot_map
        + (G * G + 1) * 7           # cv_map + max_height
    )


def occupied_positions(state: VoxelStoreState
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions [V1, 3], valid mask [V1]) of occupied slots."""
    V1 = state.slot_pos.shape[0]
    valid = torch.arange(V1, device=state.slot_pos.device) < state.num_voxels
    return state.slot_pos, valid


def fused_rgb(state: VoxelStoreState) -> torch.Tensor:
    """Weighted-mean color per slot as uint8."""
    w = state.weight.clamp_min(1e-12)[:, None]
    return (state.rgb_sum / w).clamp(0, 255).to(torch.uint8)
