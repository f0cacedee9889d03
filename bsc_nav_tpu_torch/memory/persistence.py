"""Serialization of the voxel store: the reference's on-disk bundle and a
single-file dense snapshot.

Counterpart of ``bsc_nav_tpu/memory/persistence.py``; both formats are the
JAX package's byte for byte, so a store saved by either package loads in
the other.

  save_reference_format / load_reference_format: the reference's bundle
      per scene -- ``feat.h5df`` (HDF5 groups ``grid_{r}_{c}_{h}`` with
      ``features`` [n, D] f32 and ``distances`` [n] f32), ``grid_rgb_pos``,
      ``grid_rgb``, ``weight``, ``occupied_ids``, ``max_id``,
      ``original_pos``, ``map_height``, ``base_height`` (``.npy``) and
      ``long_memory.json``.  ``h5py`` is imported inside these two
      functions: a machine without it runs everything else.
  save_npz / load_npz: one compressed ``.npz`` of the dense store's live
      prefix, bf16 rows saved as f32 and restored on load.

Loads build the store on the host in numpy and copy it to ``device``
once.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from bsc_nav_tpu_torch.config import MemoryConfig
from bsc_nav_tpu_torch.memory.store import (
    VoxelStoreState, dequantized_feats, fused_rgb, init_store)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 as f32 (numpy has no bf16, and
    JAX's ``_np_savable`` saves ml_dtypes bf16 as f32)."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def save_reference_format(
    state: VoxelStoreState,
    path: str,
    cfg: MemoryConfig,
    original_pos: Sequence[float],
    base_height: Sequence[float] = (),
    long_memory: Optional[List[dict]] = None,
) -> None:
    import h5py

    os.makedirs(path, exist_ok=True)
    n = int(state.num_voxels)
    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1
    pos = _np(state.slot_pos)[:n]
    counts = _np(state.feat_count)[:n]
    feats = _np(dequantized_feats(state)[:n])
    dists = _np(state.feat_dist).reshape(V1, K)[:n]

    with h5py.File(os.path.join(path, "feat.h5df"), "w") as h5f:
        for i in range(n):
            k = int(counts[i])
            if k == 0:
                continue
            g = h5f.create_group(f"grid_{pos[i,0]}_{pos[i,1]}_{pos[i,2]}")
            g.create_dataset("features", data=feats[i, :k],
                             maxshape=(None, feats.shape[-1]), chunks=True)
            g.create_dataset("distances", data=dists[i, :k],
                             maxshape=(None,), chunks=True)

    np.save(os.path.join(path, "grid_rgb_pos.npy"), pos.astype(np.int32))
    np.save(os.path.join(path, "grid_rgb.npy"), _np(fused_rgb(state))[:n])
    np.save(os.path.join(path, "weight.npy"),
            _np(state.weight).astype(np.float32)[:n])
    G, H = cfg.grid_size, cfg.num_height_cells
    occ = _np(state.slot_map)[: G * G * H].reshape(G, G, H)
    np.save(os.path.join(path, "occupied_ids.npy"), occ.astype(np.int32))
    np.save(os.path.join(path, "max_id.npy"), np.array(n))
    np.save(os.path.join(path, "original_pos.npy"),
            np.asarray(original_pos, dtype=np.float32))
    np.save(os.path.join(path, "map_height.npy"),
            np.array([cfg.zmin, cfg.zmax]))
    np.save(os.path.join(path, "base_height.npy"),
            np.asarray(list(base_height), dtype=np.float64))
    with open(os.path.join(path, "long_memory.json"), "w") as f:
        json.dump(long_memory or [], f, indent=4)


def load_reference_format(path: str, cfg: MemoryConfig,
                          store_dtype=torch.float32, device="cuda"):
    """Rebuild a store from a reference-format bundle: (state, meta) with
    meta = dict(original_pos, base_height, long_memory, map_height).  An
    int8 store quantizes the f32 rows on the host, in numpy, as JAX
    ``load_reference_format`` does."""
    import h5py

    n = int(np.load(os.path.join(path, "max_id.npy")))
    if n > cfg.voxel_capacity:
        raise ValueError(
            f"memory at {path} has {n} voxels > capacity {cfg.voxel_capacity}")
    pos = np.load(os.path.join(path, "grid_rgb_pos.npy"))
    rgb = np.load(os.path.join(path, "grid_rgb.npy"))
    weight = np.load(os.path.join(path, "weight.npy"))
    occ = np.load(os.path.join(path, "occupied_ids.npy"))
    minh, maxh = np.load(os.path.join(path, "map_height.npy"))
    if (int(minh), int(maxh)) != (cfg.zmin, cfg.zmax):
        raise ValueError(
            f"height range mismatch: disk ({minh},{maxh}) vs cfg "
            f"({cfg.zmin},{cfg.zmax})")

    state = init_store(cfg, store_dtype=store_dtype, device=device)
    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1
    D = state.feats.shape[1]
    G, H = cfg.grid_size, cfg.num_height_cells

    feats = np.zeros((V1, K, D), np.float32)
    dists = np.zeros((V1, K), np.float32)
    counts = np.zeros((V1,), np.int32)
    # (r, c, h) -> slot from the saved point ids: the producing run's
    # slot numbering
    slot_of = {tuple(pos[i]): i for i in range(n)}
    with h5py.File(os.path.join(path, "feat.h5df"), "r") as h5f:
        for name in h5f:
            if not name.startswith("grid_"):
                continue
            _, r, c, h = name.split("_")
            s = slot_of.get((int(r), int(c), int(h)))
            if s is None:
                continue      # a token voxel without an RGB point
            f = np.asarray(h5f[name]["features"], np.float32)
            d = np.asarray(h5f[name]["distances"], np.float32)
            k = min(len(f), K)
            feats[s, :k] = f[:k]
            dists[s, :k] = d[:k]
            counts[s] = k

    slot_map = np.full((G * G * H + 1,), -1, np.int32)
    slot_map[: G * G * H] = occ.reshape(-1)
    rgb_sum = np.zeros((V1, 3), np.float32)
    w = np.zeros((V1,), np.float32)
    w[:n] = weight
    rgb_sum[:n] = rgb.astype(np.float32) * weight[:, None]
    slot_pos = np.zeros((V1, 3), np.int32)
    slot_pos[:n] = pos

    if store_dtype == torch.int8:
        absmax = np.maximum(np.abs(feats).max(axis=-1), 1e-12)
        scale = absmax / 127.0
        q = np.clip(np.round(feats / scale[..., None]), -127, 127)
        feats_store = q.astype(np.int8)
        norms = np.linalg.norm(q, axis=-1)
        state.feat_scale.copy_(torch.from_numpy(
            scale.reshape(V1 * K).astype(np.float32)))
    else:
        feats_store = feats
        norms = np.linalg.norm(feats, axis=-1)

    def put(name, arr):
        getattr(state, name).copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    put("feats", feats_store.reshape(V1 * K, D))
    put("feat_norm", norms.reshape(V1 * K).astype(np.float32))
    put("feat_dist", dists.reshape(V1 * K))
    put("feat_count", counts)
    put("rgb_sum", rgb_sum)
    put("weight", w)
    put("slot_pos", slot_pos)
    put("slot_map", slot_map)
    state.num_voxels.fill_(n)
    state.initialized.fill_(True)

    meta = {
        "original_pos": np.load(os.path.join(path, "original_pos.npy")),
        "base_height": np.load(os.path.join(path, "base_height.npy")),
        "map_height": (int(minh), int(maxh)),
    }
    with open(os.path.join(path, "long_memory.json")) as f:
        meta["long_memory"] = json.load(f)
    return state, meta


# --- dense snapshot --------------------------------------------------------

def save_npz(state: VoxelStoreState, path: str, **extra) -> None:
    """The dense store's live prefix (n slots, n*K rows) in one compressed
    file, with the keys JAX ``save_npz`` writes."""
    n = int(state.num_voxels)
    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1

    def head(t, rows):
        return _np(t[:rows] if t.shape[0] > 1 else t[:1])

    np.savez_compressed(
        path,
        num_voxels=n,
        feats=_np(state.feats[:n * K]),
        feat_norm=_np(state.feat_norm[:n * K]),
        feat_scale=head(state.feat_scale, n * K),
        feat_dist=_np(state.feat_dist[:n * K]),
        feat_count=_np(state.feat_count[:n]),
        rgb_sum=_np(state.rgb_sum[:n]),
        weight=_np(state.weight[:n]),
        slot_pos=_np(state.slot_pos[:n]),
        cv_map=_np(state.cv_map),
        max_height=_np(state.max_height),
        inv_init_base_tf=_np(state.inv_init_base_tf),
        initialized=_np(state.initialized),
        dropped_voxels=_np(state.dropped_voxels),
        feat_sum=head(state.feat_sum, n + 1),
        feat_obs=head(state.feat_obs, n + 1),
        **extra,
    )


def load_npz(path: str, cfg: MemoryConfig, store_dtype=torch.float32,
             device="cuda") -> VoxelStoreState:
    """A store from ``save_npz``'s file (either package's): the saved
    prefix of each field over an empty store, ``slot_map`` rebuilt from
    ``slot_pos``."""
    with np.load(path, allow_pickle=False) as npz:
        z = {k: npz[k] for k in npz.files}
    n = int(z["num_voxels"])
    state = init_store(cfg, store_dtype=store_dtype, device=device)
    G, H = cfg.grid_size, cfg.num_height_cells

    def fill(name, arr):
        dst = getattr(state, name)
        dst[:len(arr)].copy_(torch.from_numpy(np.ascontiguousarray(arr)
                                              ).to(dst.dtype))

    pos = z["slot_pos"]
    slot_map = np.full((G * G * H + 1,), -1, np.int32)
    lin = (pos[:, 0].astype(np.int64) * G + pos[:, 1]) * H + pos[:, 2]
    slot_map[lin] = np.arange(n, dtype=np.int32)

    if "feat_scale" in z and z["feat_scale"].shape[0] > 1:
        fill("feat_scale", z["feat_scale"])
    if ("feat_sum" in z and z["feat_sum"].shape[0] > 1
            and state.feat_sum.shape[0] > 1):
        fill("feat_sum", z["feat_sum"])
        fill("feat_obs", z["feat_obs"])
    if "dropped_voxels" in z:
        state.dropped_voxels.fill_(int(z["dropped_voxels"]))
    for name in ("feats", "feat_norm", "feat_dist", "feat_count", "rgb_sum",
                 "weight", "slot_pos"):
        fill(name, z[name])
    state.slot_map.copy_(torch.from_numpy(slot_map))
    state.num_voxels.fill_(n)
    for name in ("cv_map", "max_height", "inv_init_base_tf", "initialized"):
        getattr(state, name).copy_(torch.from_numpy(z[name]))
    return state
