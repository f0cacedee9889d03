"""Fused cosine-similarity scan over the flat [V1*K, D] token store:
kernel K2 and its plain version.

Counterpart of ``bsc_nav_tpu/ops/similarity.py``.  For every voxel, the
max over its K cached rows of ``dot(row, q) / max(norm, 1e-12)``, with
-inf for slots at k >= count (``masked_norms``).  On a CUDA tensor the
whole scan, the per-voxel max included, is one launch of
``csrc/max_cosine.cu``; the [V1*K] row cosines never reach device memory.

int8 stores are not ported yet (ROADMAP.md): on the card they raise.
"""

from __future__ import annotations

import torch

from bsc_nav_tpu_torch.ops import _build


def masked_norms(norms_flat, counts, K: int):
    """[VK] norms + [V] counts -> [VK] with -1 marking empty slots."""
    V1 = counts.shape[0]
    k = torch.arange(K, device=counts.device)
    valid = (k[None, :] < counts[:, None]).reshape(V1 * K)
    return torch.where(valid, norms_flat.clamp_min(1e-12),
                       torch.full_like(norms_flat, -1.0))


def reference_max_cosine(feats, norms, counts, q):
    """Plain version of K2: feats [V1*K, D], norms [V1*K] f32, counts [V1]
    int32, q [D] f32 -> [V1] f32.  Rows are widened to f32 and dotted
    with the f32 query, as the TPU kernel ``_sim_kernel`` does."""
    VK = feats.shape[0]
    V1 = counts.shape[0]
    K = VK // V1
    mnorm = masked_norms(norms, counts, K)
    dots = feats.float() @ q.float()
    sims = torch.where(mnorm > 0, dots / mnorm,
                       torch.full_like(dots, float("-inf")))
    return sims.reshape(V1, K).amax(dim=1)


def max_cosine_per_voxel(feats, norms, counts, q):
    """feats [V1*K, D], norms [V1*K] f32, counts [V1] int32, q [D] f32 ->
    [V1] f32 max cosine per voxel (-inf for empty voxels).

    A CPU tensor takes ``reference_max_cosine``.  A CUDA tensor launches
    kernel K2 on the current stream without synchronising, or raises."""
    if feats.device.type == "cpu":
        return reference_max_cosine(feats, norms, counts, q)
    if feats.device.type != "cuda":
        raise ValueError(f"max_cosine_per_voxel: unsupported device "
                         f"{feats.device}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"max_cosine_per_voxel: {feats.dtype} store rows on CUDA (K2 "
            "takes float32 or bfloat16; int8 rows are queued in ROADMAP.md)")
    VK, D = feats.shape
    V1 = counts.shape[0]
    if VK % V1 or norms.shape != (VK,) or q.shape != (D,):
        raise ValueError(
            f"max_cosine_per_voxel: shapes feats {tuple(feats.shape)}, "
            f"norms {tuple(norms.shape)}, counts {tuple(counts.shape)}, "
            f"q {tuple(q.shape)}")
    if D % 8 or D > 12288:
        raise ValueError(f"max_cosine_per_voxel: D = {D} (K2 takes D % 8 "
                         "== 0, D <= 12288)")
    if (norms.dtype, counts.dtype, q.dtype) != (torch.float32, torch.int32,
                                                torch.float32):
        raise TypeError("max_cosine_per_voxel: norms f32, counts int32, "
                        "q f32 expected")
    for name, t in (("feats", feats), ("norms", norms), ("counts", counts),
                    ("q", q)):
        if t.device != feats.device or not t.is_contiguous():
            raise ValueError(f"max_cosine_per_voxel: {name} must be "
                             f"contiguous on {feats.device}")
    if feats.data_ptr() % 16:
        raise ValueError("max_cosine_per_voxel: feats must be 16-byte "
                         "aligned (the kernel reads 16-byte vectors)")
    out = torch.empty(V1, dtype=torch.float32, device=feats.device)
    rc = _build.kernels().max_cosine_per_voxel_launch(
        feats.data_ptr(), norms.data_ptr(), counts.data_ptr(), q.data_ptr(),
        out.data_ptr(), V1, VK // V1, D, int(feats.dtype == torch.bfloat16),
        torch.cuda.current_stream(feats.device).cuda_stream)
    _build.check(rc, "max_cosine_per_voxel")
    max_cosine_per_voxel.launches += 1
    return out


max_cosine_per_voxel.launches = 0


def max_cosine(feats, norms, counts, q):
    """Canonical dispatch used by memory/query.py."""
    return max_cosine_per_voxel(feats, norms, counts, q)
