"""Segmented voxel store: scenes larger than one store's capacity.

Counterpart of ``bsc_nav_tpu/memory/segments.py``.  Ingest targets the
ACTIVE segment; once it holds ``rotate_at`` of its capacity it is frozen
and a fresh one started, which carries the frame chain and the top-down
maps forward.  The newest ``max_device_segments`` frozen segments stay on
the device; older ones spill to host memory and are streamed back through
the device at query time.  A query localizes in every segment and merges
the candidates by voxel position (a voxel revisited after a rotation lies
in several segments; its maximum score wins).

Frozen segments are quantized on the device by default
(``freeze_dtype="int8"``: per-row absmax codes, ``store.
quantize_feat_rows``): their rows take a quarter of an f32 segment's
bytes on the device and in a spill, and cosines stay exact over the codes.
The
policy was tuned in the JAX package for a host link of 0.03 GB/s; its
semantics are kept here, where the link is PCIe.

Differences from the JAX version, by design:

- Ingest writes the active state in place, so a fresh segment gets its own
  copies of the top-down maps and frame chain (JAX shares its immutable
  arrays); later flushes never write into a frozen segment.
- A spilled segment holds torch CPU tensors, pinned when the segment came
  from a card, so that its copies to and from the card are direct DMA.
- Each segment's scan runs on the segment's device: the active and
  device segments through ``query.localize``, a spilled segment's n x K
  rows copied to the active segment's device and scanned there (K2 for
  f32 and bf16 rows, K2b at Q 1 for int8 rows on a card); masks, the
  per-segment top-K and the merge run on the host in numpy, as JAX's do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.config import MemoryConfig
from bsc_nav_tpu_torch.memory import query as Q
from bsc_nav_tpu_torch.memory.store import (
    VoxelStoreState, init_store, quantize_feat_rows)
from bsc_nav_tpu_torch.ops.similarity import max_cosine


def spill(state: VoxelStoreState) -> dict:
    """The query-relevant prefix of a frozen segment in host memory:
    ``feats`` / ``feat_norm`` [n*K], ``feat_count`` / ``slot_pos`` [n],
    ``n``, ``K`` (JAX ``_freeze``).  A segment on a card is copied into
    pinned buffers."""
    n = int(state.num_voxels)
    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1
    pin = state.feats.device.type == "cuda"

    def host(t, rows):
        out = torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                          pin_memory=pin)
        out.copy_(t[:rows])
        return out

    return {"feats": host(state.feats, n * K),
            "feat_norm": host(state.feat_norm, n * K),
            "feat_count": host(state.feat_count, n),
            "slot_pos": host(state.slot_pos, n), "n": n, "K": K}


class SegmentedStore:
    """One active store and the frozen segments.

    Ingest into ``state`` (reassign it after each build step), call
    ``rotate_if_full()`` between batches and ``localize()`` for queries.
    ``device`` defaults to the card and raises without one."""

    def __init__(self, cfg: MemoryConfig, store_dtype=torch.float32,
                 max_device_segments: int = 2, rotate_at: float = 0.95,
                 freeze_dtype="int8", device="cuda"):
        self.cfg = cfg
        self.store_dtype = store_dtype
        self.max_device_segments = max_device_segments
        self.rotate_threshold = int(cfg.voxel_capacity * rotate_at)
        # "int8": frozen segments quantized on the device; None: frozen in
        # store_dtype
        self.freeze_dtype = freeze_dtype
        self.device = resolve_device(device)
        self.state = init_store(cfg, store_dtype=store_dtype,
                                device=self.device)
        self.device_segments: List[VoxelStoreState] = []
        self.host_segments: List[dict] = []

    @property
    def num_segments(self) -> int:
        return 1 + len(self.device_segments) + len(self.host_segments)

    def total_voxels(self) -> int:
        return (int(self.state.num_voxels)
                + sum(int(s.num_voxels) for s in self.device_segments)
                + sum(s["n"] for s in self.host_segments))

    def rotate_if_full(self) -> bool:
        """Freeze the active segment when it holds ``rotate_threshold``
        voxels; start a fresh one that keeps the frame chain and the
        top-down maps (copies).  Spill the oldest device segments past
        ``max_device_segments``."""
        if int(self.state.num_voxels) < self.rotate_threshold:
            return False
        frozen = self.state
        if self.freeze_dtype == "int8" and frozen.feats.dtype != torch.int8:
            qi, qnorm, qscale = quantize_feat_rows(frozen.feats,
                                                   frozen.feat_norm)
            frozen = dataclasses.replace(frozen, feats=qi, feat_norm=qnorm,
                                         feat_scale=qscale)
        fresh = init_store(self.cfg, store_dtype=self.store_dtype,
                           device=self.device)
        for f in ("inv_init_base_tf", "initialized", "cv_map", "max_height"):
            getattr(fresh, f).copy_(getattr(frozen, f))
        self.state = fresh
        self.device_segments.append(frozen)
        while len(self.device_segments) > self.max_device_segments:
            self.host_segments.append(spill(self.device_segments.pop(0)))
        return True

    # ------------------------------------------------------------------
    def _localize_host_segment(self, seg: dict, qn: torch.Tensor,
                               top_k: int, **masks
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Stream one spilled segment through the active segment's device
        and scan it there; the region and floor masks and the top-K on the
        host, as JAX's (``segments.py:138-162``)."""
        n = seg["n"]
        if n == 0:
            return np.zeros((0, 3), np.int32), np.zeros((0,), np.float32)
        dev = qn.device
        rows = [seg[f].to(dev, non_blocking=True)
                for f in ("feats", "feat_norm", "feat_count")]
        per_voxel = max_cosine(*rows, qn).cpu().numpy()
        pos = seg["slot_pos"].numpy()
        keep = np.ones((n,), bool)
        if masks.get("use_region"):
            d2 = np.sum((pos.astype(np.float64) - _np(masks["curr_grid"]
                                                      ).astype(np.float64)
                         [None]) ** 2, axis=-1)
            keep &= d2 <= float(masks["region_radius"]) ** 2
        if masks.get("use_floor"):
            fr = _np(masks["floor_range"])
            keep &= (pos[:, 2] >= fr[0]) & (pos[:, 2] <= fr[1])
        per_voxel = np.where(keep, per_voxel[:n], -np.inf)
        idx = np.argsort(-per_voxel)[:min(top_k, n)]
        return pos[idx], per_voxel[idx].astype(np.float32)

    def localize(self, query: torch.Tensor, top_k: int = 100,
                 **masks) -> Tuple[np.ndarray, np.ndarray]:
        """Global top-K across all segments: (positions [<=top_k, 3]
        int32, scores [<=top_k] f32) as numpy, deduplicated by position
        (the maximum score, the first seen on ties; active segment, then
        device segments, then spilled ones), sorted stably by score."""
        query = query.to(self.state.feats.device)
        qn = query.to(torch.float32)
        qn = qn / torch.linalg.norm(qn).clamp_min(1e-12)

        cands_pos, cands_score = [], []
        for seg_state in [self.state] + self.device_segments:
            p, s = Q.localize(seg_state, query, top_k=top_k, **masks)
            p, s = p.cpu().numpy(), s.cpu().numpy()
            live = s > -np.inf
            cands_pos.append(p[live])
            cands_score.append(s[live])
        for seg in self.host_segments:
            p, s = self._localize_host_segment(seg, qn, top_k, **masks)
            live = s > -np.inf
            cands_pos.append(p[live])
            cands_score.append(s[live])

        if not any(len(p) for p in cands_pos):
            return np.zeros((0, 3), np.int32), np.zeros((0,), np.float32)
        pos = np.concatenate([p for p in cands_pos if len(p)])
        score = np.concatenate([s for s in cands_score if len(s)])
        best = {}
        for p, s in zip(map(tuple, pos.tolist()), score.tolist()):
            if s > best.get(p, -np.inf):
                best[p] = s
        items = sorted(best.items(), key=lambda kv: -kv[1])[:top_k]
        return (np.asarray([k for k, _ in items], np.int32),
                np.asarray([v for _, v in items], np.float32))


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
