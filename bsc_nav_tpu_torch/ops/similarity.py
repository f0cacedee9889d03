"""Fused cosine-similarity scan over the flat [V1*K, D] token store:
kernel K2, its Q-query form, and their plain versions.

Counterpart of ``bsc_nav_tpu/ops/similarity.py``.  For every voxel, the
max over its K cached rows of ``dot(row, q) / max(norm, 1e-12)``, with
-inf for slots at k >= count (``masked_norms``).  On a CUDA tensor the
whole scan, the per-voxel max included, is one launch of
``csrc/max_cosine.cu``; the [V1*K] row cosines never reach device memory.

Rows may be f32, bf16 or int8 (per-row absmax codes whose ``feat_norm`` is
the int8 row's norm, so the scale cancels).  The single-query scan keeps
an f32 query for float rows, as the TPU kernel does, and rounds it to bf16
for int8 rows, as the JAX einsum does: on the card a single query on int8
rows is the Q-query kernel at Q = 1, which holds its query so.  The
Q-query scan (``max_cosine_per_voxel_batch``) rounds its queries to the
store dtype (bf16 for int8), as the JAX batch einsum does.  Both hold to their own JAX
counterpart, so the two differ on float rows by the rounding of the query.
"""

from __future__ import annotations

import torch

from bsc_nav_tpu_torch.ops import _build

# the Q-query kernel's dtype codes; values per 16-byte load
_DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8), torch.int8: (2, 16)}
BATCH_QUERIES = 16      # queries one launch of the Q-query kernel holds
_BATCH_MAX_D = 3584     # f32 rows: 16 x D f32 + 2 KB of scratch in 227 KB
                        # of smem (bf16 and int8 rows: 16 x D bf16)


def masked_norms(norms_flat, counts, K: int):
    """[VK] norms + [V] counts -> [VK] with -1 marking empty slots."""
    V1 = counts.shape[0]
    k = torch.arange(K, device=counts.device)
    valid = (k[None, :] < counts[:, None]).reshape(V1 * K)
    return torch.where(valid, norms_flat.clamp_min(1e-12),
                       torch.full_like(norms_flat, -1.0))


def _per_voxel_max(dots, norms, counts):
    """dots [..., VK] f32 -> [..., V1]: masked, divided, max over K."""
    V1 = counts.shape[0]
    K = dots.shape[-1] // V1
    mnorm = masked_norms(norms, counts, K)
    sims = torch.where(mnorm > 0, dots / mnorm,
                       torch.full_like(dots, float("-inf")))
    return sims.reshape(*dots.shape[:-1], V1, K).amax(dim=-1)


def reference_max_cosine(feats, norms, counts, q):
    """Plain version of K2: feats [V1*K, D], norms [V1*K] f32, counts [V1]
    int32, q [D] f32 -> [V1] f32.  Rows are widened to f32 and dotted
    with the f32 query, as the TPU kernel ``_sim_kernel`` does; for int8
    rows the query is rounded to bf16 first (the JAX einsum's operands),
    so every product is exact in f32."""
    qf = q.float()
    if feats.dtype == torch.int8:
        qf = qf.to(torch.bfloat16).float()
    return _per_voxel_max(feats.float() @ qf, norms, counts)


def _check_scan(name, feats, norms, counts, q_shape, q):
    """Raise on what the K2 launchers do not take."""
    VK, D = feats.shape
    V1 = counts.shape[0]
    if feats.dtype not in _DTYPES:
        raise NotImplementedError(
            f"{name}: {feats.dtype} store rows (K2 takes float32, bfloat16 "
            "or int8)")
    if V1 == 0 or VK % V1 or norms.shape != (VK,) or q.shape != q_shape:
        raise ValueError(
            f"{name}: shapes feats {tuple(feats.shape)}, norms "
            f"{tuple(norms.shape)}, counts {tuple(counts.shape)}, q "
            f"{tuple(q.shape)}")
    per16 = _DTYPES[feats.dtype][1]
    if D % per16 or D > 12288:
        raise ValueError(f"{name}: D = {D} ({feats.dtype} rows take D % "
                         f"{per16} == 0, D <= 12288)")
    if (norms.dtype, counts.dtype, q.dtype) != (torch.float32, torch.int32,
                                                torch.float32):
        raise TypeError(f"{name}: norms f32, counts int32, q f32 expected")
    for arg, t in (("feats", feats), ("norms", norms), ("counts", counts),
                   ("q", q)):
        if t.device != feats.device or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous on "
                             f"{feats.device}")
    if feats.data_ptr() % 16:
        raise ValueError(f"{name}: feats must be 16-byte aligned (the "
                         "kernel reads 16-byte vectors)")


def max_cosine_per_voxel(feats, norms, counts, q):
    """feats [V1*K, D] f32 / bf16 / int8, norms [V1*K] f32, counts [V1]
    int32, q [D] f32 -> [V1] f32 max cosine per voxel (-inf for empty
    voxels).

    A CPU tensor takes ``reference_max_cosine``.  A CUDA tensor launches
    kernel K2 on the current stream without synchronising, or raises; int8
    rows launch the Q-query kernel at Q = 1 instead (counted by
    ``max_cosine_per_voxel_batch``), whose query rounding to bf16 is the
    int8 semantics of ``reference_max_cosine``."""
    if feats.device.type == "cpu":
        return reference_max_cosine(feats, norms, counts, q)
    if feats.device.type != "cuda":
        raise ValueError(f"max_cosine_per_voxel: unsupported device "
                         f"{feats.device}")
    _check_scan("max_cosine_per_voxel", feats, norms, counts,
                (feats.shape[1],), q)
    if feats.dtype == torch.int8:
        return max_cosine_per_voxel_batch(feats, norms, counts, q[None])[0]
    VK, D = feats.shape
    V1 = counts.shape[0]
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


def reference_max_cosine_batch(feats, norms, counts, qs):
    """Plain version of the Q-query scan, the GEMM composition: qs [Q, D]
    f32 rounded to the store dtype (bf16 for int8 rows), as JAX's
    ``max_cosine_per_voxel_batch`` does; ``feats.float() @ qs.T``, the
    count mask, the divide and the max over each voxel's K rows ->
    [Q, V1] f32."""
    qdt = torch.bfloat16 if feats.dtype == torch.int8 else feats.dtype
    qr = qs.float().to(qdt).float()
    return _per_voxel_max((feats.float() @ qr.T).T, norms, counts)


def max_cosine_per_voxel_batch(feats, norms, counts, qs):
    """feats [V1*K, D] f32 / bf16 / int8, norms [V1*K] f32, counts [V1]
    int32, qs [Q, D] f32 -> [Q, V1] f32: every voxel's max cosine for each
    query, in one pass over the store per 16 queries.

    A CPU tensor takes ``reference_max_cosine_batch``.  A CUDA tensor
    launches the Q-query kernel once per ``BATCH_QUERIES`` queries on the
    current stream without synchronising (each launch counted), or
    raises: bf16 and int8 rows on the tensor cores (bf16 products, exact;
    f32 sums in the order of ``mma.sync``'s k16 steps), f32 rows on the
    CUDA cores (``csrc/max_cosine.cu``)."""
    if feats.device.type == "cpu":
        return reference_max_cosine_batch(feats, norms, counts, qs)
    if feats.device.type != "cuda":
        raise ValueError(f"max_cosine_per_voxel_batch: unsupported device "
                         f"{feats.device}")
    VK, D = feats.shape
    if qs.dim() != 2 or qs.shape[0] == 0:
        raise ValueError(f"max_cosine_per_voxel_batch: qs {tuple(qs.shape)}"
                         " (want [Q, D], Q >= 1)")
    _check_scan("max_cosine_per_voxel_batch", feats, norms, counts,
                (qs.shape[0], D), qs)
    if D > _BATCH_MAX_D:
        raise ValueError(f"max_cosine_per_voxel_batch: D = {D} (16 queries "
                         "of D f32 must fit a block's 227 KB of shared "
                         f"memory: D <= {_BATCH_MAX_D})")
    Q, V1 = qs.shape[0], counts.shape[0]
    out = torch.empty(Q, V1, dtype=torch.float32, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    lib = _build.kernels()
    for q0 in range(0, Q, BATCH_QUERIES):
        nq = min(BATCH_QUERIES, Q - q0)
        rc = lib.max_cosine_batch_launch(
            feats.data_ptr(), norms.data_ptr(), counts.data_ptr(),
            qs[q0].data_ptr(), out[q0].data_ptr(), V1, VK // V1, D, nq,
            _DTYPES[feats.dtype][0], stream)
        _build.check(rc, "max_cosine_per_voxel_batch")
        max_cosine_per_voxel_batch.launches += 1
    return out


max_cosine_per_voxel_batch.launches = 0
