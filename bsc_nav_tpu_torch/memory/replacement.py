"""Cache consolidation: the forgetting pass over every voxel.

Counterpart of ``bsc_nav_tpu/memory/replacement.py``: within each
voxel's token cache, tokens whose pairwise cosine exceeds ``threshold``
are grouped (K rounds of min-label propagation over the K x K adjacency,
the connected components of union-find) and replaced by their group means
-- features and distances -- compacted to the front in the order of each
group's first row.  An int8 store groups on its codes (the per-row scales
cancel in the cosine), averages the dequantized rows and requantizes each
mean with a fresh scale (``store.quantize_rows``).

JAX vmaps the pass over all V1 voxels; this runs it batched over chunks of
voxels, in place, up to the last voxel holding a token, and writes what
JAX computes for an empty voxel past it (rows of zeros, norms and
distances 0, int8 scales 1.0), so the state is JAX's field for field.
The products run in full f32 whatever the caller's matmul flags.
"""

from __future__ import annotations

import torch

from bsc_nav_tpu_torch import full_f32_matmul
from bsc_nav_tpu_torch.memory.store import VoxelStoreState, quantize_rows

CHUNK_ELEMENTS = 1 << 27      # f32 elements of one chunk's [C, K, D] rows


def _component_labels(adj: torch.Tensor, rounds: int) -> torch.Tensor:
    """[C, K, K] adjacency (self loops set) -> [C, K] labels: ``rounds``
    rounds of label <- min over the neighbours' labels, from the row
    index; K rounds reach each component's minimum."""
    C, K, _ = adj.shape
    labels = torch.arange(K, device=adj.device).expand(C, K)
    for _ in range(rounds):
        labels = torch.minimum(labels, torch.where(
            adj, labels[:, None, :], K).amin(dim=2))
    return labels


def consolidate(feats, norms, dists, counts, threshold: float,
                scales=None):
    """Voxels feats [C, K, D] (store dtype), norms, dists [C, K] f32,
    counts [C] int32, int8 scales [C, K] or None -> the compacted
    (feats, norms, dists, counts, scales) of JAX ``_consolidate_one``
    (``replacement.py:24-83``), one voxel per row of the batch."""
    C, K, D = feats.shape
    dev = feats.device
    ks = torch.arange(K, device=dev)
    kmask = ks < counts[:, None]                                 # [C, K]
    f32 = feats.to(torch.float32)
    with full_f32_matmul():
        sims = torch.bmm(f32, f32.transpose(1, 2))               # [C, K, K]
    sims = sims / (norms[:, :, None] * norms[:, None, :]).clamp_min(1e-12)
    adj = ((sims > threshold) & kmask[:, :, None] & kmask[:, None, :]
           | torch.eye(K, dtype=torch.bool, device=dev))
    labels = torch.where(kmask, _component_labels(adj, K), K)

    fdeq = f32 if scales is None else f32 * scales[..., None]
    one_hot = ((labels[:, :, None] == ks) & kmask[:, :, None]).to(
        torch.float32)                                           # [C, k, g]
    gcount = one_hot.sum(dim=1)                                  # [C, K]
    with full_f32_matmul():
        gsum = torch.bmm(one_hot.transpose(1, 2), fdeq)          # [C, K, D]
    gdist = (one_hot * dists[:, :, None]).sum(dim=1)
    live = gcount > 0
    gmean = gsum / gcount.clamp_min(1.0)[..., None]
    gmean_dist = gdist / gcount.clamp_min(1.0)
    if scales is not None:
        codes, _, gscale = quantize_rows(gmean.reshape(C * K, D))
        gmean = codes.to(torch.float32).view(C, K, D)

    # compact the live groups to the front, in order (stable)
    dest = torch.where(live, torch.cumsum(live, dim=1) - 1, K)   # [C, K]
    out_f = torch.zeros(C, K + 1, D, device=dev).scatter_(
        1, dest[..., None].expand(C, K, D), gmean)[:, :K]
    out_d = torch.zeros(C, K + 1, device=dev).scatter_(
        1, dest, gmean_dist)[:, :K]
    out_n = torch.sqrt(out_f.double().square().sum(dim=-1)).float()
    out_s = None
    if scales is not None:
        out_s = torch.ones(C, K + 1, device=dev).scatter_(
            1, dest, gscale.view(C, K))[:, :K]
    new_count = torch.minimum(live.sum(dim=1).to(counts.dtype), counts)
    return out_f.to(feats.dtype), out_n, out_d, new_count, out_s


def forgetting_pass(state: VoxelStoreState,
                    threshold: float = 0.95) -> VoxelStoreState:
    """Merge near-duplicate cached tokens in every voxel, in place;
    returns ``state``.  int8 stores consolidate dequantized rows and
    refresh ``feat_scale``."""
    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1
    D = state.feats.shape[1]
    is_int8 = (state.feats.dtype == torch.int8
               and state.feat_scale.shape[0] > 1)
    held = torch.nonzero(state.feat_count > 0)
    hi = int(held[-1, 0]) + 1 if held.shape[0] else 0
    feats = state.feats.view(V1, K, D)
    norms = state.feat_norm.view(V1, K)
    dists = state.feat_dist.view(V1, K)
    scales = state.feat_scale.view(V1, K) if is_int8 else None
    step = max(1, CHUNK_ELEMENTS // (K * D))
    for c0 in range(0, hi, step):
        c1 = min(hi, c0 + step)
        f, n, d, c, s = consolidate(
            feats[c0:c1], norms[c0:c1], dists[c0:c1],
            state.feat_count[c0:c1], threshold,
            scales[c0:c1] if is_int8 else None)
        feats[c0:c1], norms[c0:c1], dists[c0:c1] = f, n, d
        state.feat_count[c0:c1] = c
        if is_int8:
            scales[c0:c1] = s
    # voxels past the last one holding a token, as an empty voxel comes out
    feats[hi:] = 0
    norms[hi:] = 0.0
    dists[hi:] = 0.0
    if is_int8:
        scales[hi:] = 1.0
    return state
