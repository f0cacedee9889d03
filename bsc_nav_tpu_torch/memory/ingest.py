"""Batched RGB-D frame ingestion into the voxel token store.

Counterpart of ``bsc_nav_tpu/memory/ingest.py`` (dist policy).  Points
carry a global frame-major ``order`` index, and every conflict between
points that touch the same voxel is resolved as the sequential reference
loop would: first-touch slot assignment in arrival order, append-then-
random-replace token caching where the later point wins a contested
row, a top-down map where the highest (height, order) wins, and RGB
fusion as weighted sums.

Differences from the JAX version, by design:

- The store is updated **in place** and the same state object is
  returned; the JAX version donates the buffer to its jitted step instead
  (``pipeline.py:59``).
- Random draws come from a ``torch.Generator``, which cannot reproduce
  ``jax.random``.  ``pix [B, P]`` (pixel subset, with replacement) and
  ``repl_idx [N]`` (replacement slots) may be injected instead; tests
  rebuild them from the JAX key and inject them.
- Scatters that JAX drops out of range (``mode="drop"``) write the
  garbage row here (slot V, cell G*G, voxel id G*G*H).  Each data row
  still has exactly one writer, so no host sync is needed to select the
  live rows, and the garbage rows' contents are undefined, as in JAX.
- ``rgb_sum`` and ``weight`` are summed with ``index_add_``; on CUDA that
  uses atomics, so their float sums vary in the last bits from run to
  run.  Every integer field is deterministic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bsc_nav_tpu.config import Config
from bsc_nav_tpu_torch import geometry as G
from bsc_nav_tpu_torch.memory.store import VoxelStoreState, linear_voxel_id

_BIG = torch.iinfo(torch.int64).max


def points_per_frame(cfg: Config) -> int:
    """Static subsample count: ceil(H*W / depth_sample_rate)."""
    hw = cfg.sensor.height * cfg.sensor.width
    return -(-hw // cfg.memory.depth_sample_rate)


def _run_heads(sorted_key: torch.Tensor) -> torch.Tensor:
    """True at the first element of each run of equal live keys."""
    head = torch.ones_like(sorted_key, dtype=torch.bool)
    head[1:] = sorted_key[1:] != sorted_key[:-1]
    return head & (sorted_key != _BIG)


def ingest_frames(
    state: VoxelStoreState,
    rgb: torch.Tensor,          # [B, H, W, 3] uint8
    depth: torch.Tensor,        # [B, H, W]    f32 (metres)
    poses: torch.Tensor,        # [B, 7]       f32 (px,py,pz,qx,qy,qz,qw)
    patch_tokens: torch.Tensor, # [B, nh, nw, D]
    generator: Optional[torch.Generator],
    cfg: Config,
    pix: Optional[torch.Tensor] = None,       # [B, P] int pixel draws
    repl_idx: Optional[torch.Tensor] = None,  # [N]    int slot draws
) -> Tuple[VoxelStoreState, dict]:
    """Scatter a batch of frames into the store, in place.  Returns
    (state, stats).  Draws not injected come from ``generator``."""
    mem = cfg.memory
    if mem.replacement != "dist":
        raise NotImplementedError(
            f"replacement={mem.replacement!r}: the surprise policy is queued "
            "in ROADMAP.md (Queue 1 item 11)")
    dev = state.feats.device
    B, H, W = depth.shape
    Gs, Hc = mem.grid_size, mem.num_height_cells
    V, K, D = mem.voxel_capacity, mem.cache_size, mem.token_dim
    V1 = state.feat_count.shape[0]        # padded slot rows; garbage slot V
    nh, nw = patch_tokens.shape[1], patch_tokens.shape[2]
    P = points_per_frame(cfg)
    N = B * P

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    base_tf = f32(G.base_axes_transform())
    base2cam = f32(G.base_to_cam_transform(cfg.sensor.sensor_height))
    inv_calib = torch.linalg.inv_ex(
        f32(G.camera_intrinsics(H, W, cfg.sensor.hfov_deg))).inverse
    patch_intr = f32(G.patch_intrinsics(nh, nw))

    # --- frame chain: initialized on the very first frame ever ------------
    poses = poses.to(torch.float32)
    inv_init = torch.where(state.initialized, state.inv_init_base_tf,
                           G.initial_base_inverse(poses[0], base_tf))
    cam2world = G.camera_to_world_transform(poses, inv_init, base_tf,
                                            base2cam)          # [B, 4, 4]

    # --- point selection + backprojection ---------------------------------
    if pix is None:
        pix = torch.randint(0, H * W, (B, P), generator=generator,
                            device=dev)
    if repl_idx is None:
        repl_idx = torch.randint(0, K, (N,), generator=generator, device=dev)
    pix = pix.to(device=dev, dtype=torch.int64)
    repl_idx = repl_idx.to(device=dev, dtype=torch.int64)
    py_img, px_img = pix // W, pix % W

    z = depth.reshape(B, H * W).gather(1, pix).to(torch.float32)   # [B, P]
    uv1 = torch.stack([px_img.to(torch.float32) + 0.5,
                       py_img.to(torch.float32) + 0.5,
                       torch.ones_like(z)], dim=-1)              # [B, P, 3]
    rays = uv1 @ inv_calib.T
    p_local = rays * z[..., None]                     # camera-frame points
    valid = (z > cfg.sensor.min_depth) & (z < cfg.sensor.max_depth)
    p_world = (p_local @ cam2world[:, :3, :3].transpose(1, 2)
               + cam2world[:, None, :3, 3])

    # --- voxel ids ---------------------------------------------------------
    rc = G.world_to_grid(p_world, Gs, mem.cell_size)      # [B, P, 3]
    valid &= G.grid_in_range(rc, Gs, mem.zmin, mem.zmax)
    rc[..., 2] -= mem.zmin                                # shift h >= 0

    # --- patch-token lookup ------------------------------------------------
    ppx, ppy, _ = G.project_points(patch_intr, p_local)
    valid &= (ppx >= 0) & (ppy >= 0) & (ppx < nw) & (ppy < nh)
    ppx = ppx.clamp(0, nw - 1).long()
    ppy = ppy.clamp(0, nh - 1).long()
    b_idx = torch.arange(B, device=dev)[:, None]
    token = patch_tokens[b_idx, ppy, ppx]                  # [B, P, D]
    rgb_v = rgb.reshape(B, H * W, 3).gather(
        1, pix[..., None].expand(B, P, 3)).to(torch.float32)   # [B, P, 3]

    radial_sq = (p_local * p_local).sum(dim=-1)
    alpha = torch.exp(-radial_sq / f32(2.0 * mem.alpha_sigma_sq))

    # --- flatten frame-major: order preserves sequential semantics --------
    rc = rc.reshape(N, 3).long()
    valid = valid.reshape(N)
    token = token.reshape(N, D)
    rgb_v = rgb_v.reshape(N, 3)
    alpha = alpha.reshape(N)
    radial_sq = radial_sq.reshape(N)
    order = torch.arange(N, device=dev)

    GARBAGE_LID = Gs * Gs * Hc                    # extra slot_map row
    lid = torch.where(valid, linear_voxel_id(rc, Gs, Hc), GARBAGE_LID)

    # ======================================================================
    # 1. first-touch slot assignment, slots handed out in arrival order
    # ======================================================================
    looked = state.slot_map[lid]
    is_new = valid & (looked == -1)
    # stable sort by voxel id: run heads hold each new voxel's first point
    sorted_key, perm = torch.sort(torch.where(is_new, lid, _BIG), stable=True)
    first_by_point = torch.empty_like(is_new)
    first_by_point[perm] = _run_heads(sorted_key)
    arrival_rank = torch.cumsum(first_by_point, 0) - 1
    n_new_total = first_by_point.sum()

    new_slot = state.num_voxels + arrival_rank
    fits = first_by_point & (new_slot < V)
    state.slot_map[torch.where(fits, lid, GARBAGE_LID)] = torch.where(
        fits, new_slot, -1).to(torch.int32)
    state.slot_map[GARBAGE_LID] = -1
    state.slot_pos[torch.where(fits, new_slot, V)] = rc.to(torch.int32)

    total = state.num_voxels + n_new_total
    state.dropped_voxels += (total - V).clamp_min(0).to(torch.int32)
    state.num_voxels.copy_(total.clamp_max(V))

    # re-gather: every valid point now has a slot (or -1 over capacity)
    slot = state.slot_map[lid]
    valid &= slot >= 0
    slot_g = torch.where(valid, slot.long(), V)           # garbage slot V

    # ======================================================================
    # 2. RGB fusion: weighted sums (order-free)
    # ======================================================================
    a = torch.where(valid, alpha, 0.0)
    state.rgb_sum.index_add_(0, slot_g, a[:, None] * rgb_v)
    state.weight.index_add_(0, slot_g, a)

    # ======================================================================
    # 3. top-down cv_map: the (height, order)-max point wins
    # ======================================================================
    cell = torch.where(valid, rc[:, 0] * Gs + rc[:, 1], Gs * Gs)
    packed = torch.where(valid, (rc[:, 2] + 1) * (N + 1) + order, -1)
    cell_best = torch.full((Gs * Gs + 1,), -1, dtype=torch.int64,
                           device=dev).scatter_reduce_(0, cell, packed, "amax")
    won = (valid & (packed == cell_best[cell])
           & (rc[:, 2] >= state.max_height[cell]))
    wcell = torch.where(won, cell, Gs * Gs)
    state.cv_map[wcell] = rgb_v.clamp(0, 255).to(torch.uint8)
    state.max_height[wcell] = rc[:, 2].to(torch.int32)

    # ======================================================================
    # 4. token cache insert, dist policy: append while count < K, then the
    #    injected/drawn replacement slot; the later point wins a row
    # ======================================================================
    tok_norm = torch.sqrt((token.to(torch.float32) ** 2).sum(dim=-1))
    s_sorted, idx_sorted = torch.sort(torch.where(valid, slot_g, _BIG),
                                      stable=True)
    pos_in_sort = torch.arange(N, device=dev)
    run_start = torch.cummax(
        torch.where(_run_heads(s_sorted), pos_in_sort, -1), 0).values
    rank_by_point = torch.empty_like(pos_in_sort)
    rank_by_point[idx_sorted] = pos_in_sort - run_start  # rank within voxel

    pos_k = state.feat_count[slot_g] + rank_by_point
    write_k = torch.where(pos_k < K, pos_k, repl_idx)
    target = torch.where(valid, slot_g * K + write_k, V1 * K)
    cache_best = torch.full((V1 * K + 1,), -1, dtype=torch.int64,
                            device=dev).scatter_reduce_(0, target, order,
                                                        "amax")
    cache_won = valid & (cache_best[target] == order)
    wrow = torch.where(cache_won, slot_g * K + write_k, V * K)

    state.feats[wrow] = token.to(state.feats.dtype)
    state.feat_norm[wrow] = tok_norm
    state.feat_dist[wrow] = radial_sq

    inserted = torch.zeros(V1, dtype=torch.int32, device=dev).index_add_(
        0, slot_g, valid.to(torch.int32))
    state.feat_count.copy_((state.feat_count + inserted).clamp_max(K))

    state.inv_init_base_tf.copy_(inv_init)
    state.initialized.fill_(True)
    stats = {
        "points_valid": valid.sum(),
        "new_voxels": n_new_total,
        "num_voxels": state.num_voxels.clone(),
        "dropped_voxels": state.dropped_voxels.clone(),
    }
    return state, stats
