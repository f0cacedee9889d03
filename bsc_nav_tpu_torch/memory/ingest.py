"""Batched RGB-D frame ingestion into the voxel token store.

Counterpart of ``bsc_nav_tpu/memory/ingest.py`` (both replacement
policies; f32, bf16 and int8 stores -- an int8 store takes each written
token as per-row absmax codes, its scale in ``feat_scale``).  Points
carry a global frame-major ``order`` index, and every conflict between
points that touch the same voxel is resolved as the sequential reference
loop would: first-touch slot assignment in arrival order, append-then-
replace token caching where the later point wins a contested row, a
top-down map where the highest (height, order) wins, and RGB fusion as
weighted sums.

Token caching follows ``cfg.memory.replacement``:

- ``"dist"``: a full cache replaces a randomly drawn row.
- ``"surprise"``: a point of a voxel that existed before the batch is
  cached only if it is novel against the voxel's 26 neighbours (radius
  ``neighbor_radius``): its minimum cosine distance to their pre-batch
  running mean tokens (``surprise_exact=False``) or to every token they
  cache (``surprise_exact=True``, in chunks of 512 points) exceeds
  ``surprise_threshold``; a point with no live neighbour is novel.  A
  full cache replaces its row most similar to the incoming token (the
  first on ties), and every valid point adds to its voxel's running sum
  and count.  Neighbour slots are read after this batch's new voxels
  were assigned; every statistic and cached row before the batch writes
  any (JAX ``ingest.py:239-306``, ``:324-335``).  The cosines are
  elementwise products and sums in f32, on the int8 codes for an int8
  store (the scale cancels); the norm of a neighbour mean is XLA's CPU
  reduction, an FMA chain in index order (``fma_norm``).

Differences from the JAX version, by design:

- The store is updated **in place** and the same state object is
  returned; the JAX version donates the buffer to its jitted step instead
  (``pipeline.py:59``).
- Random draws come from a ``torch.Generator``, which cannot reproduce
  ``jax.random``.  ``pix [B, P]`` (pixel subset, with replacement) and
  ``repl_idx [N]`` (replacement slots) may be injected instead; tests
  rebuild them from the JAX key and inject them.  The surprise policy
  draws no replacement slots and ignores ``repl_idx``.
- The float geometry (camera-frame and world points) may be injected as
  ``points``.  Its last bits are not the same in every XLA build: the
  jitted 3-term products become fused multiply-add chains on some host
  codegens and plain products and sums on others, and a point on an
  axis-aligned wall then falls into the neighbouring voxel.  Tests hold
  the port's points to JAX's within an ulp bound and inject JAX's to
  compare everything downstream exactly.
- Scatters that JAX drops out of range (``mode="drop"``) write the
  garbage row here (slot V, cell G*G, voxel id G*G*H).  Each data row
  still has exactly one writer, so no host sync is needed to select the
  live rows, and the garbage rows' contents are undefined, as in JAX.
- ``rgb_sum`` and ``weight`` are summed with ``index_add_``; on CUDA that
  uses atomics, so their float sums vary in the last bits from run to
  run.  Every integer field is deterministic.

A store split over mp ranks along its capacity axis (``ShardedStoreState``,
``parallel/mesh.shard_store``) takes the same batch on every rank: the
index side (slot assignment, ``slot_map``, the top-down map, every
conflict resolution) is computed whole and identically on each, and each
rank applies only the reads and writes of its own slot rows, at ``slot -
shard_base``; writes to other ranks' rows (and the garbage row's) are
dropped.  The surprise policy reads neighbour rows that may sit on another
rank and is refused on a sharded store (``ShardedSurpriseError``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bsc_nav_tpu_torch import full_f32_matmul
from bsc_nav_tpu_torch.config import Config
from bsc_nav_tpu_torch import geometry as G
from bsc_nav_tpu_torch.memory.store import (
    VoxelStoreState, linear_voxel_id, quantize_rows)


class ShardedSurpriseError(NotImplementedError):
    """``replacement="surprise"`` on a store sharded over mp > 1: the gate
    reads neighbour voxels' rows, which may sit on another rank (no JAX
    test runs the surprise policy on a mesh either)."""

_BIG = torch.iinfo(torch.int64).max
SURPRISE_CHUNK = 512      # points per gather of the exact surprise gate


def points_per_frame(cfg: Config) -> int:
    """Static subsample count: ceil(H*W / depth_sample_rate)."""
    hw = cfg.sensor.height * cfg.sensor.width
    return -(-hw // cfg.memory.depth_sample_rate)


def _run_heads(sorted_key: torch.Tensor) -> torch.Tensor:
    """True at the first element of each run of equal live keys."""
    head = torch.ones_like(sorted_key, dtype=torch.bool)
    head[1:] = sorted_key[1:] != sorted_key[:-1]
    return head & (sorted_key != _BIG)


def fma_norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of f32 ``x`` as jitted XLA forms
    ``jnp.linalg.norm`` on the CPU at small widths: the squares summed by
    a fused multiply-add chain in index order (each step exact in f64,
    rounded once to f32), the root correctly rounded.  One f32 += f64
    addition a step (the addition runs in f64 and rounds once)."""
    sq = x.double().square()                           # exact
    acc = sq[..., 0].float()
    for i in range(1, x.shape[-1]):
        acc.add_(sq[..., i])
    return torch.sqrt(acc.double()).float()


def _cos_rows(rows: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """dot(rows[..., j, :], tok) over the last axis in full f32:
    rows [N, ..., D] widened to f32, tok [N, D] f32."""
    shape = (tok.shape[0],) + (1,) * (rows.dim() - 2) + (tok.shape[1],)
    return (rows.to(torch.float32) * tok.view(shape)).sum(dim=-1)


def _neighbour_slots(rc, slot_map, mem):
    """(slot [N, n], in grid [N, n]) of each point's neighbours at radius
    ``neighbor_radius``, read from ``slot_map`` (absent: garbage slot V)."""
    Gs, Hc, V = mem.grid_size, mem.num_height_cells, mem.voxel_capacity
    r = mem.neighbor_radius
    offs = torch.tensor([(dr, dc, dh)
                         for dr in range(-r, r + 1)
                         for dc in range(-r, r + 1)
                         for dh in range(-r, r + 1)
                         if (dr, dc, dh) != (0, 0, 0)], device=rc.device)
    nrc = rc[:, None, :] + offs[None]                       # [N, n, 3]
    n_ok = ((nrc[..., 0] >= 0) & (nrc[..., 0] < Gs)
            & (nrc[..., 1] >= 0) & (nrc[..., 1] < Gs)
            & (nrc[..., 2] >= 0) & (nrc[..., 2] < Hc))
    nlid = torch.where(n_ok, linear_voxel_id(nrc, Gs, Hc), Gs * Gs * Hc)
    ns = slot_map[nlid].long()
    return torch.where(ns >= 0, ns, V), n_ok


def _surprise(state, token, tok_norm, nslot, n_ok, judged,
              mem) -> torch.Tensor:
    """[N] novelty of each token: its minimum cosine distance to its
    neighbours' pre-batch baseline (+inf without a live neighbour), and
    +inf where not ``judged`` (a point of a voxel new in this batch)."""
    inf = torch.tensor(float("inf"), device=token.device)
    if not mem.surprise_exact:
        n_obs = state.feat_obs[nslot]                        # [N, n]
        n_ok = n_ok & (n_obs > 0)
        n_mean = state.feat_sum[nslot] / n_obs.clamp_min(1.0)[..., None]
        cos = _cos_rows(n_mean, token) / (
            fma_norm(n_mean) * tok_norm[:, None]).clamp_min(1e-12)
        novel = torch.where(n_ok, 1.0 - cos, inf).amin(dim=-1)
        return torch.where(judged, novel, inf)
    K = mem.cache_size
    ks = torch.arange(K, device=token.device)
    out = []
    for c0 in range(0, token.shape[0], SURPRISE_CHUNK):
        ns = nslot[c0:c0 + SURPRISE_CHUNK]                   # [C, n]
        rows = ns[..., None] * K + ks                        # [C, n, K]
        cos = _cos_rows(state.feats[rows], token[c0:c0 + SURPRISE_CHUNK])
        cos = cos / (state.feat_norm[rows] * tok_norm[
            c0:c0 + SURPRISE_CHUNK, None, None]).clamp_min(1e-12)
        live = (n_ok[c0:c0 + SURPRISE_CHUNK, :, None]
                & (ks < state.feat_count[ns][..., None]))
        out.append(torch.where(live, 1.0 - cos, inf).amin(dim=(1, 2)))
    return torch.where(judged, torch.cat(out), inf)


def _most_similar(state, slot_g, token, tok_norm, K) -> torch.Tensor:
    """[N] the replacement row of each point: its voxel's cached row most
    similar to the token (pre-batch rows and counts; the first on ties,
    row 0 for an empty cache)."""
    rows = slot_g[:, None] * K + torch.arange(K, device=token.device)
    csim = _cos_rows(state.feats[rows], token) / (
        state.feat_norm[rows] * tok_norm[:, None]).clamp_min(1e-12)
    kmask = torch.arange(K, device=token.device) < state.feat_count[
        slot_g][:, None]
    return torch.where(kmask, csim, float("-inf")).argmax(dim=-1)


def _scatter_rows(t: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                  keep: torch.Tensor, garbage: int,
                  lo: Optional[int]) -> None:
    """t[rows[i]] = vals[i] where ``keep``.  A whole store (``lo`` None)
    sends the others to row ``garbage``; a shard whose first global row is
    ``lo`` writes only its own rows, at ``row - lo``, and drops the rest."""
    if lo is None:
        t[torch.where(keep, rows, garbage)] = vals
        return
    sel = torch.nonzero(keep & (rows >= lo)
                        & (rows < lo + t.shape[0])).squeeze(1)
    t[rows[sel] - lo] = vals[sel]


def _add_rows(t: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              lo: Optional[int]) -> None:
    """t[rows[i]] += vals[i] (``index_add_``); a shard adds only its own
    rows' terms (the others add zero to its row 0)."""
    if lo is not None:
        local = rows - lo
        mine = (local >= 0) & (local < t.shape[0])
        rows = torch.where(mine, local, 0)
        vals = torch.where(mine.view((-1,) + (1,) * (vals.dim() - 1)), vals,
                           torch.zeros_like(vals))
    t.index_add_(0, rows, vals)


def frame_points(depth: torch.Tensor, pix: torch.Tensor,
                 cam2world: torch.Tensor, cfg: Config):
    """Depth, camera-frame and world points of the pixels ``pix`` [B, P]
    of ``depth`` [B, H, W]: (z [B, P], p_local, p_world [B, P, 3]),
    all f32."""
    B, H, W = depth.shape
    f32 = dict(dtype=torch.float32, device=depth.device)
    inv_calib = torch.linalg.inv_ex(torch.as_tensor(
        G.camera_intrinsics(H, W, cfg.sensor.hfov_deg), **f32)).inverse
    py_img, px_img = pix // W, pix % W
    z = depth.reshape(B, H * W).gather(1, pix).to(torch.float32)
    uv1 = torch.stack([px_img.to(torch.float32) + 0.5,
                       py_img.to(torch.float32) + 0.5,
                       torch.ones_like(z)], dim=-1)              # [B, P, 3]
    p_local = (uv1 @ inv_calib.T) * z[..., None]
    p_world = (p_local @ cam2world[:, :3, :3].transpose(1, 2)
               + cam2world[:, None, :3, 3])
    return z, p_local, p_world


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
    points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[VoxelStoreState, dict]:
    """Scatter a batch of frames into the store, in place.  Returns
    (state, stats).  Draws not injected come from ``generator``;
    ``points`` = (p_local, p_world) [B, P, 3] f32 replaces the float
    geometry of the drawn pixels.  Every product runs in full f32,
    whatever the caller's TF32 and matmul precision flags (voxel ids
    follow the last bit of the geometry)."""
    with full_f32_matmul():
        return _ingest(state, rgb, depth, poses, patch_tokens, generator,
                       cfg, pix, repl_idx, points)


def _ingest(state, rgb, depth, poses, patch_tokens, generator, cfg, pix,
            repl_idx, points):
    mem = cfg.memory
    surprise = mem.replacement == "surprise"
    dev = state.feats.device
    B, H, W = depth.shape
    Gs, Hc = mem.grid_size, mem.num_height_cells
    V, K, D = mem.voxel_capacity, mem.cache_size, mem.token_dim
    V1l = state.feat_count.shape[0]       # this store's slot rows
    shards = getattr(state, "shard_count", 1)
    V1 = V1l * shards                     # padded slot rows; garbage slot V
    # a shard's first global slot (None: a whole store)
    lo = state.shard_base if shards > 1 else None
    if surprise and lo is not None:
        raise ShardedSurpriseError(
            f"replacement='surprise' on a store sharded over {shards} ranks")
    nh, nw = patch_tokens.shape[1], patch_tokens.shape[2]
    P = points_per_frame(cfg)
    N = B * P

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    base_tf = f32(G.base_axes_transform())
    base2cam = f32(G.base_to_cam_transform(cfg.sensor.sensor_height))
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
    if repl_idx is None and not surprise:
        repl_idx = torch.randint(0, K, (N,), generator=generator, device=dev)
    pix = pix.to(device=dev, dtype=torch.int64)
    z, p_local, p_world = frame_points(depth, pix, cam2world, cfg)
    if points is not None:
        p_local, p_world = (p.to(device=dev, dtype=torch.float32)
                            for p in points)
    valid = (z > cfg.sensor.min_depth) & (z < cfg.sensor.max_depth)

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
    _scatter_rows(state.slot_pos, new_slot, rc.to(torch.int32), fits, V, lo)

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
    _add_rows(state.rgb_sum, slot_g, a[:, None] * rgb_v, lo)
    _add_rows(state.weight, slot_g, a, lo)

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
    # 4. token cache insert: append while count < K, then the replacement
    #    row (dist: the injected/drawn slot; surprise: the most similar
    #    cached row); the later point wins a row
    # ======================================================================
    token = token.to(torch.float32)
    tok_norm = torch.sqrt((token ** 2).sum(dim=-1))
    cache_valid = valid
    if surprise:
        nslot, n_ok = _neighbour_slots(rc, state.slot_map, mem)
        novel = _surprise(state, token, tok_norm, nslot, n_ok,
                          valid & (looked >= 0), mem)
        cache_valid = valid & (novel > mem.surprise_threshold)
        repl_idx = _most_similar(state, slot_g, token, tok_norm, K)
        # running statistics take every valid observation
        state.feat_sum.index_add_(0, slot_g, token)
        state.feat_obs.index_add_(0, slot_g, valid.to(torch.float32))
    else:
        repl_idx = repl_idx.to(device=dev, dtype=torch.int64)
    s_sorted, idx_sorted = torch.sort(torch.where(cache_valid, slot_g, _BIG),
                                      stable=True)
    pos_in_sort = torch.arange(N, device=dev)
    run_start = torch.cummax(
        torch.where(_run_heads(s_sorted), pos_in_sort, -1), 0).values
    rank_by_point = torch.empty_like(pos_in_sort)
    rank_by_point[idx_sorted] = pos_in_sort - run_start  # rank within voxel

    # a shard reads its own slots' counts; the other points' rows belong to
    # other shards, whatever is read for them here
    count_g = (state.feat_count[slot_g] if lo is None else
               state.feat_count[(slot_g - lo).clamp(0, V1l - 1)])
    pos_k = count_g + rank_by_point
    write_k = torch.where(pos_k < K, pos_k, repl_idx)
    target = torch.where(cache_valid, slot_g * K + write_k, V1 * K)
    cache_best = torch.full((V1 * K + 1,), -1, dtype=torch.int64,
                            device=dev).scatter_reduce_(0, target, order,
                                                        "amax")
    cache_won = cache_valid & (cache_best[target] == order)
    row = slot_g * K + write_k
    row_lo = None if lo is None else lo * K

    if state.feats.dtype == torch.int8:
        # per-token absmax codes (JAX ingest.py:352-362); the scale cancels
        # in the cosine, so feat_norm holds the int8 row's norm
        stored, tok_norm, scale = quantize_rows(token)
        _scatter_rows(state.feat_scale, row, scale, cache_won, V * K, row_lo)
    else:
        stored = token.to(state.feats.dtype)
    for t, vals in ((state.feats, stored), (state.feat_norm, tok_norm),
                    (state.feat_dist, radial_sq)):
        _scatter_rows(t, row, vals, cache_won, V * K, row_lo)

    inserted = torch.zeros(V1, dtype=torch.int32, device=dev).index_add_(
        0, slot_g, cache_valid.to(torch.int32))
    if lo is not None:
        inserted = inserted[lo:lo + V1l]
    state.feat_count.copy_((state.feat_count + inserted).clamp_max(K))

    state.inv_init_base_tf.copy_(inv_init)
    state.initialized.fill_(True)
    stats = {
        "points_valid": valid.sum(),
        "points_cached": cache_valid.sum(),
        "new_voxels": n_new_total,
        "num_voxels": state.num_voxels.clone(),
        "dropped_voxels": state.dropped_voxels.clone(),
    }
    return state, stats
