"""Device-resident voxel token store.

Counterpart of ``bsc_nav_tpu/memory/store.py``: the same fields, dtypes
and flat layout.  Token (slot, k) lives at row ``slot*K + k`` of the
[V1*K, D] ``feats`` table; every array carries a trailing garbage row
(slot ``V`` = ``voxel_capacity``, cell ``G*G``, voxel id ``G*G*H``) that
masked scatters write to instead of dropping.  Garbage rows hold
undefined values and are never read as data.

Rows are float32, bfloat16 or int8.  An int8 store holds per-row absmax
codes (``quantize_feat_rows``) with their scales in ``feat_scale`` [V1*K]
and the int8 row's norm in ``feat_norm``, so the scale cancels in the
cosine; ``quantize_store`` converts a float store, on its device.  Under
``replacement="surprise"`` the store also keeps each voxel's running
token sum and observation count (``feat_sum`` [V1, D], ``feat_obs``
[V1]), the surprise gate's mean-field baseline; the dist policy keeps
size-1 placeholders there.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from bsc_nav_tpu_torch.config import MemoryConfig
from bsc_nav_tpu_torch import resolve_device


@dataclasses.dataclass
class VoxelStoreState:
    """All device-side memory state (V = voxel_capacity, K = cache_size,
    D = token_dim, G = grid_size, H = num_height_cells, V1 = padded
    slot rows).  Ingest updates these tensors in place."""

    # --- token cache, flat [V1*K, D] ---------------------------------------
    feats: torch.Tensor        # [V1*K, D] store dtype
    feat_norm: torch.Tensor    # [V1*K] f32   (||stored token||)
    feat_scale: torch.Tensor   # [V1*K | 1] f32 (int8 dequant scales)
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
    feat_sum: torch.Tensor     # [V1 | 1, D] f32 (running token sum)
    feat_obs: torch.Tensor     # [V1 | 1] f32    (observation count)

    # --- frame chain -------------------------------------------------------
    inv_init_base_tf: torch.Tensor  # [4, 4] f32
    initialized: torch.Tensor       # [] bool


@dataclasses.dataclass
class ShardedStoreState(VoxelStoreState):
    """One rank's shard of a store split over ``shard_count`` ranks along
    the capacity axis (``parallel/mesh.shard_store``): slot rows
    [shard_index * Vl, (shard_index + 1) * Vl) of ``feats``, ``feat_norm``,
    ``feat_scale``, ``feat_dist``, ``feat_count``, ``rgb_sum``, ``weight``,
    ``slot_pos`` (and ``feat_sum`` / ``feat_obs`` where they are per slot),
    Vl = V1 / shard_count; the index side (``slot_map``, ``num_voxels``,
    ``dropped_voxels``, ``cv_map``, ``max_height``, the frame chain) whole
    and equal on every rank.  ``ingest_frames`` writes only this shard's
    rows."""

    shard_index: int = 0
    shard_count: int = 1

    @property
    def shard_base(self) -> int:
        """The global slot of this shard's first row."""
        return self.shard_index * self.feat_count.shape[0]


def linear_voxel_id(rc: torch.Tensor, grid_size: int,
                    num_h: int) -> torch.Tensor:
    """(row, col, h-shifted) -> flat id in [0, G*G*H)."""
    return (rc[..., 0] * grid_size + rc[..., 1]) * num_h + rc[..., 2]


def padded_rows(cfg: MemoryConfig) -> int:
    """Slot-table rows: capacity + garbage row, padded to a multiple of 8
    (the JAX package's mesh divisibility, kept for the same layout)."""
    return ((cfg.voxel_capacity + 1 + 7) // 8) * 8


def init_store(cfg: MemoryConfig, store_dtype=torch.float32,
               device="cuda") -> VoxelStoreState:
    if store_dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"store dtype {store_dtype}: float32, bfloat16 or "
                         "int8")
    if cfg.replacement not in ("dist", "surprise"):
        raise ValueError(f"replacement={cfg.replacement!r}: 'dist' or "
                         "'surprise'")
    dev = resolve_device(device)
    K, D = cfg.cache_size, cfg.token_dim
    G, H = cfg.grid_size, cfg.num_height_cells
    V1 = padded_rows(cfg)
    S = V1 if cfg.replacement == "surprise" else 1

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return VoxelStoreState(
        feats=zeros((V1 * K, D), store_dtype),
        feat_norm=zeros((V1 * K,), torch.float32),
        feat_scale=zeros((V1 * K if store_dtype == torch.int8 else 1,),
                         torch.float32),
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
        feat_sum=zeros((S, D), torch.float32),
        feat_obs=zeros((S,), torch.float32),
        inv_init_base_tf=torch.eye(4, dtype=torch.float32, device=dev),
        initialized=zeros((), torch.bool),
    )


def quantize_rows(f: torch.Tensor):
    """Token rows [N, D] f32 -> (int8 codes, int8-row norms, scales), the
    per-row symmetric absmax int8 of JAX ``ingest.py:352-362`` and
    ``store.py:131-149``: scale = max(max |f|, 1e-12) / 127, codes
    round(f / scale) (a true division, ties to even) clipped to +-127, and
    the codes' norm.  XLA folds the division by the constant 127 into a
    product with its f32 reciprocal, and so does this.  The codes' sum of
    squares is exact in f32 for D <= 1040; its root is taken in f64 and
    rounded once, so it is correctly rounded on every host (PyTorch's
    vectorised f32 ``sqrt`` is not on AVX-512)."""
    absmax = f.abs().amax(dim=-1)
    scale = absmax.clamp_min(1e-12) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32, device=f.device)
    q = torch.round(f / scale[:, None]).clamp(-127, 127)
    norm = torch.sqrt((q * q).sum(dim=-1).double()).float()
    return q.to(torch.int8), norm, scale


def quantize_feat_rows(feats: torch.Tensor, feat_norm: torch.Tensor):
    """[VK, D] float token rows -> (int8 rows, int8-row norms, scales),
    as JAX ``quantize_feat_rows``: rows never written (norm 0) keep norm
    0."""
    qi, norm, scale = quantize_rows(feats.to(torch.float32))
    return qi, torch.where(feat_norm > 0, norm, torch.zeros_like(norm)), scale


def quantize_store(state: VoxelStoreState) -> VoxelStoreState:
    """The int8 form of a float store, on its device (JAX
    ``quantize_store``): feats, feat_norm and feat_scale are replaced in
    the returned state, the other fields are shared with ``state``.
    Ingest into the result takes the int8 write branch.  An int8 store is
    returned as it is."""
    if state.feats.dtype == torch.int8:
        return state
    qi, norm, scale = quantize_feat_rows(state.feats, state.feat_norm)
    return dataclasses.replace(state, feats=qi, feat_norm=norm,
                               feat_scale=scale)


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


def token_cache_view(state: VoxelStoreState):
    """(feats [V1, K, D], norms [V1, K], dists [V1, K]) views of the flat
    store."""
    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1
    D = state.feats.shape[1]
    return (state.feats.view(V1, K, D), state.feat_norm.view(V1, K),
            state.feat_dist.view(V1, K))


def dequantized_feats(state: VoxelStoreState) -> torch.Tensor:
    """The token cache as f32 [V1, K, D]: the rows widened, times their
    scales for an int8 store."""
    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1
    f = state.feats.to(torch.float32)
    if state.feats.dtype == torch.int8:
        f = f * state.feat_scale[:, None]
    return f.view(V1, K, -1)


def fused_rgb(state: VoxelStoreState) -> torch.Tensor:
    """Weighted-mean color per slot as uint8."""
    w = state.weight.clamp_min(1e-12)[:, None]
    return (state.rgb_sum / w).clamp(0, 255).to(torch.uint8)
