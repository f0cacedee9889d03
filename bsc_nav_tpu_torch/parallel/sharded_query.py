"""Distributed query over a capacity-sharded token store.

Counterpart of ``bsc_nav_tpu/parallel/sharded_query.py``.  For a store
split over the mp axis (``parallel/mesh.shard_store``) each rank

  scans its local [Vl*K, D] slab (kernel K2 on f32 and bf16 rows, K2b at
  Q 1 on int8 rows), masks the slots past ``num_voxels``, and takes a
  local top-k of min(top_k, Vl)                          (no communication)
  all-gathers the k*mp (score, slot position) candidates over mp, in rank
  order                                                  (one collective)
  takes the top-K of the concatenation               (replicated result)

moving k*mp candidates instead of the V-sized score vector.  Ties go to
the lower index of the concatenation, as ``lax.top_k`` orders them.

The semantics are those of JAX's per-shard ``_local`` (``:39-74``), not of
the single ``memory/query.localize``: on a bf16 store the unit query is
rounded to bf16 (``qn.astype(feats.dtype)``); on an int8 store both sides
are bf16 (K2b's Q 1 rounding); on f32 rows the query stays f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bsc_nav_tpu_torch.memory.query import stable_top_k
from bsc_nav_tpu_torch.memory.store import VoxelStoreState
from bsc_nav_tpu_torch.ops.similarity import max_cosine


def make_sharded_localize(mesh, top_k: int = 100):
    """(feats, feat_norm, feat_count, slot_pos, num_voxels, query) ->
    (positions [top_k, 3], scores [top_k]) on this rank's shard: the four
    store tensors are the rank's slabs of the capacity axis (``mesh.py``
    ``store_sharding``), ``num_voxels`` and ``query`` are whole."""

    def local(feats, norm, count, pos, num_voxels, query):
        Vl = count.shape[0]
        base = mesh.m * Vl                          # global slot offset
        qn = query.to(torch.float32)
        qn = qn / torch.linalg.norm(qn).clamp_min(1e-12)
        if feats.dtype == torch.bfloat16:
            qn = qn.to(torch.bfloat16).to(torch.float32)
        per_voxel = max_cosine(feats, norm, count, qn)
        occupied = (base + torch.arange(Vl, device=feats.device)) < num_voxels
        per_voxel = torch.where(occupied, per_voxel,
                                torch.full_like(per_voxel, float("-inf")))
        loc_scores, loc_idx = stable_top_k(per_voxel, min(top_k, Vl))
        all_scores = torch.cat(mesh.all_gather(loc_scores, "mp"))
        all_pos = torch.cat(mesh.all_gather(pos[loc_idx], "mp"))
        g_scores, g_idx = stable_top_k(all_scores, top_k)
        return all_pos[g_idx], g_scores

    return local


def sharded_localize(state: VoxelStoreState, query: torch.Tensor, mesh,
                     top_k: int = 100
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K voxels of ``query`` over a store split over the mesh's mp
    axis, on every rank.  A whole store (mp 1, or rows that did not split)
    is scanned as this rank's share of it, as shard_map splits a
    replicated operand."""
    fields = (state.feats, state.feat_norm, state.feat_count, state.slot_pos)
    if getattr(state, "shard_count", 1) != mesh.mp:
        V1 = state.feat_count.shape[0]
        if V1 % mesh.mp:
            raise ValueError(f"sharded_localize: {V1} slot rows do not split "
                             f"over mp {mesh.mp}")
        Vl = V1 // mesh.mp
        K = state.feats.shape[0] // V1
        lo = mesh.m * Vl
        fields = (state.feats[lo * K:(lo + Vl) * K],
                  state.feat_norm[lo * K:(lo + Vl) * K],
                  state.feat_count[lo:lo + Vl], state.slot_pos[lo:lo + Vl])
    return make_sharded_localize(mesh, top_k)(*fields, state.num_voxels,
                                              query)
