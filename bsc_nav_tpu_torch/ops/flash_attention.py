"""Attention for the ViT, CLIP and MMDiT towers: kernels K1, K3, K4, K5 and
K6 and their plain versions.

Counterpart of ``bsc_nav_tpu/ops/flash_attention.py``, with its dispatch:
``attention_from_qkv`` takes the fused-QKV kernel K1
(``csrc/short_attention_qkv.cu``) only where ``use_fused_qkv_attention``
holds, as the JAX package does, and otherwise splits heads and calls
``attention``, which routes by shape (``attention_route``): K3
``short_attention`` (``csrc/short_attention.cu``) for at most 640 keys, K5
``mid_attention`` (``csrc/mid_attention.cu``) for non-causal attention over
at most 4096 keys, K6 ``flash_attention`` (``csrc/flash_attention.cu``)
where the f32 logits would pass 4e9 bytes, and the plain composition
``reference_attention`` otherwise.  The MMDiT's joint attention goes
through ``joint_qkv_dispatch`` / ``self_qkv_dispatch`` to K4
``joint_qkv_attention`` (``csrc/joint_qkv_attention.cu``) where
``use_joint_qkv_attention`` holds.  Each kernel chooses its device kernel
by dtype:

- bf16: tensor-core tiles that round P to bf16 and are held to the plain
  versions by ``flash_attention_bf16_tolerance``: K4, and K5 and K6 at
  head_dim 64, on the TMA tile (``csrc/attention_tma.cuh``), K1, K3 and
  the other head_dims on ``csrc/attention_mma.cuh``.  K1 reads q, k and v
  in place from the fused [B, S, 3*D] rows and is held to
  ``short_attention_qkv_bf16_tolerance``.  K4 first writes the joint fused
  rows with its qk-norm applied (a pre-pass, ``joint_qk_norm``: q-hat and
  k-hat rounded to bf16), then reads them in place; it is held to that
  order's plain version ``joint_qkv_attention_bf16_reference`` by
  ``joint_qkv_attention_bf16_tolerance``.
- f32: K1, K3, K4, K5 and K6 run a tensor-core tile
  (``csrc/attention_tf32.cuh``) that takes every f32 product as three TF32
  products (a_lo b_hi + a_hi b_lo + a_hi b_hi), which keeps f32's
  accuracy: they are held to their plain versions by 2e-5 abs (K4 after
  its f32 pre-pass).

Tensor parallelism (``parallel/mesh``): ``qkv_tp_permutation`` puts a
fused qkv projection's columns in the head-blocked layout, and
``attention_from_qkv_tp`` / ``joint_qkv_attention_tp`` run one rank's
heads (K1 / K4 at heads/mp) with no collective.

Layouts follow the JAX package: ``attention``, ``short_attention``,
``mid_attention``, ``flash_attention`` and ``reference_attention`` take
[B, H, S, Dh]; the fused-QKV functions take [B, S, 3*D] (q | k | v column
groups, heads contiguous inside each group) and return [B, S, D].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bsc_nav_tpu_torch.ops import _build

_NEG_INF = -1e30
# flash_attention.py:158-160, the JAX package's values: the longest key
# sequence K1 and K3 serve; the longest K5 and K4 take; the logits size
# past which K6 takes what K5 does not
_SHORT_MAX_KV = 640
_MID_MAX_KV = 4096
_FLASH_MIN_LOGITS_BYTES = 4e9
# the plain versions of K5 and K6 build [chunk, Sq, Sk] f32 logits at most
# this large, chunking over B*H (K6's shapes would need 12.6 GB at once)
_PLAIN_LOGITS_BYTES = 1 << 30


def reference_attention(q, k, v, causal: bool = False, scale=None):
    """Plain attention, f32 accumulation.  [B, H, S, Dh] -> same shape."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = logits.shape[-2:]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _split_heads(qkv, heads: int):
    B, S, threeD = qkv.shape
    hd = threeD // 3 // heads
    q, k, v = (qkv.reshape(B, S, 3, heads, hd)[:, :, i].transpose(1, 2)
               for i in range(3))
    return q, k, v


def short_attention_qkv_reference(qkv, heads: int):
    """Plain version of K1: what ``_qkv_kernel_3in`` computes, in f32 --
    q scaled by 1/sqrt(hd), max-subtracted exp, P @ V divided by the row
    sum -- cast back to the input dtype."""
    B, S, threeD = qkv.shape
    q, k, v = (t.float() for t in _split_heads(qkv, heads))
    logits = (q * (1.0 / math.sqrt(q.shape[-1]))) @ k.transpose(-1, -2)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (p @ v) / p.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2).reshape(B, S, threeD // 3).to(qkv.dtype)


def kernel_supports(head_dim: int, causal: bool = False) -> bool:
    """K1's argument check: non-causal, head_dim a multiple of 16 up to
    128.  Any head count and any sequence length (the kernel streams K/V
    tiles).  Which calls reach K1 is ``use_fused_qkv_attention``'s rule."""
    return not causal and head_dim % 16 == 0 and 16 <= head_dim <= 128


def use_fused_qkv_attention(seq_len: int, heads: int, head_dim: int,
                            causal: bool = False) -> bool:
    """True when ``attention_from_qkv`` takes K1: the JAX package's rule
    (``flash_attention.py:234-241``), non-causal, S <= 640, head_dim 64
    and an even head count.  The JAX package also asks for a TPU backend;
    here the tensor's device decides only between kernel and plain
    version, so CPU and card route alike."""
    return (not causal and seq_len <= _SHORT_MAX_KV and head_dim == 64
            and heads % 2 == 0)


def short_attention_qkv(qkv, heads: int):
    """Fused-QKV attention [B, S, 3*D] -> [B, S, D].

    A CPU tensor takes ``short_attention_qkv_reference``.  A CUDA tensor
    launches kernel K1 (``csrc/short_attention_qkv.cu``: bf16 on the wgmma
    tile, within ``short_attention_qkv_bf16_tolerance``; f32 on the TF32
    tile, three TF32 products per f32 product, within 2e-5 abs) on the
    current stream without synchronising, or raises for what it does not
    take.
    """
    if qkv.device.type == "cpu":
        return short_attention_qkv_reference(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"short_attention_qkv: unsupported device "
                         f"{qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"short_attention_qkv: dtype {qkv.dtype} (kernel "
                        "takes float32 or bfloat16)")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"short_attention_qkv: qkv shape {tuple(qkv.shape)}"
                         f" is not [B, S, 3*D] with D divisible by {heads}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("short_attention_qkv: qkv must be contiguous and "
                         "16-byte aligned (the kernel reads vectors)")
    B, S, threeD = qkv.shape
    hd = threeD // 3 // heads
    if not kernel_supports(hd):
        raise NotImplementedError(
            f"short_attention_qkv: head_dim {hd} (K1 takes multiples of 16 "
            "up to 128)")
    out = torch.empty(B, S, threeD // 3, dtype=qkv.dtype, device=qkv.device)
    rc = _build.kernels().short_attention_qkv_launch(
        qkv.data_ptr(), out.data_ptr(), B, S, heads, hd,
        int(qkv.dtype == torch.bfloat16),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(rc, "short_attention_qkv")
    short_attention_qkv.launches += 1
    return out


short_attention_qkv.launches = 0


def _check_cuda_input(name: str, *tensors) -> None:
    """Raise for what a kernel does not take: another dtype, a
    non-contiguous or misaligned buffer (the kernels read 16-byte rows and
    never copy an input quietly)."""
    for t in tensors:
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name}: dtype {t.dtype} (kernel takes float32 "
                            "or bfloat16)")
        if t.dtype != tensors[0].dtype or t.device != tensors[0].device:
            raise ValueError(f"{name}: inputs differ in dtype or device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             "aligned (the kernel reads vectors)")


def short_attention_reference(q, k, v, causal: bool = False):
    """Plain version of K3: what ``_short_kernel`` computes, in f32 -- q
    scaled by 1/sqrt(Dh) before the dot, the causal mask q_pos >= k_pos,
    a max-subtracted exp, P @ V divided by the row sum -- cast back to the
    input dtype.  [B, H, Sq, Dh], [B, H, Sk, Dh] x 2 -> [B, H, Sq, Dh]."""
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = (qf * (1.0 / math.sqrt(q.shape[-1]))) @ kf.transpose(-1, -2)
    if causal:
        s_q, s_k = logits.shape[-2:]
        keep = (torch.arange(s_q, device=q.device)[:, None]
                >= torch.arange(s_k, device=q.device)[None, :])
        logits = logits.masked_fill(~keep, _NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return ((p @ vf) / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _chunked_reference(q, k, v, causal: bool):
    """``short_attention_reference`` over chunks of B*H, each building at
    most ``_PLAIN_LOGITS_BYTES`` of f32 logits."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    per = max(1, int(_PLAIN_LOGITS_BYTES // (4 * Sq * Sk)))
    qf, kf, vf = (t.reshape(B * H, -1, hd) for t in (q, k, v))
    out = torch.cat([short_attention_reference(qf[i:i + per], kf[i:i + per],
                                               vf[i:i + per], causal)
                     for i in range(0, B * H, per)])
    return out.reshape(B, H, Sq, hd)


def mid_attention_reference(q, k, v):
    """Plain version of K5: what ``_mid_kernel`` computes, in f32 -- q
    scaled by 1/sqrt(Dh) before the dot, keys past Sk masked, a
    max-subtracted exp, P @ V divided by the row sum -- cast back to the
    input dtype, in chunks of B*H."""
    return _chunked_reference(q, k, v, False)


def flash_attention_reference(q, k, v, causal: bool = False):
    """Plain version of K6: what ``_flash_kernel``'s online softmax sums to,
    in f32 -- q scaled by 1/sqrt(Dh), keys past Sk masked, the causal mask
    q_pos >= k_pos, a max-subtracted exp, P @ V divided by the row sum --
    cast back to the input dtype, in chunks of B*H."""
    return _chunked_reference(q, k, v, causal)


def _bf16_ulp(x):
    """One bf16 ulp at the magnitude of each element of x."""
    mag = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# bf16's unit roundoff: rounding to nearest moves a value by at most this
# fraction of itself (8 significant bits)
_BF16_U = 2.0 ** -8


def flash_attention_bf16_tolerance(q, k, v, want, causal: bool = False):
    """Elementwise bound on |out - want| for K3 ``short_attention``, K5
    ``mid_attention`` and K6 ``flash_attention`` on bf16 inputs, want being
    ``flash_attention_reference(q, k, v, causal)`` (which equals
    ``short_attention_reference`` and ``mid_attention_reference`` in f32).

    Their tensor-core tile rounds each p <= 1 to bf16 before P @ V (as the
    JAX package's ``reference_attention`` casts ``probs.astype(v.dtype)``),
    a relative error of at most u = 2^-8 (bf16's unit roundoff), while the
    plain versions, and the Pallas K3 and K5, keep P in f32.
    So |out - plain| <= 2^-8 * sum_j p_j |v_j| / l, plus one bf16 ulp of
    the output and the f32 reordering (2e-5); sum_j p_j |v_j| / l is the
    plain version on |v|.  The bound is that worst case, every p rounded
    by the most in the same direction as its v."""
    spread = flash_attention_reference(q.float(), k.float(), v.float().abs(),
                                       causal)
    return 2e-5 + _bf16_ulp(want) + _BF16_U * spread


def short_attention_qkv_bf16_tolerance(qkv, heads: int, want):
    """Elementwise bound on |out - want| for K1 ``short_attention_qkv`` on
    bf16 inputs [B, S, 3*D], want being
    ``short_attention_qkv_reference(qkv, heads)`` [B, S, D].  K1's bf16
    path runs the tile of K3, K5 and K6 on the same rows, so this is
    ``flash_attention_bf16_tolerance`` on the split heads."""
    B, S, threeD = qkv.shape
    D = threeD // 3
    q, k, v = _split_heads(qkv, heads)
    tol = flash_attention_bf16_tolerance(
        q, k, v, want.reshape(B, S, heads, D // heads).transpose(1, 2))
    return tol.transpose(1, 2).reshape(B, S, D)


def _attention_shapes(name: str, q, k, v, causal: bool) -> None:
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    if causal and Sq != Sk:
        raise ValueError(f"{name}: causal requires Sq == Sk, got {Sq} != "
                         f"{Sk}")
    if k.shape != (B, H, Sk, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")


def _launch_attention(name: str, q, k, v, *flags):
    """Launch K3, K5 or K6 (``{name}_launch``, one device kernel) on the
    current stream, after the checks that a CUDA tensor must pass."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_cuda_input(name, q, k, v)
    B, H, Sq, hd = q.shape
    if hd % 16 or not 16 <= hd <= 128:
        raise NotImplementedError(f"{name}: head_dim {hd} (the kernel takes "
                                  "multiples of 16 up to 128)")
    out = torch.empty_like(q)
    rc = getattr(_build.kernels(), f"{name}_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, Sq,
        k.shape[2], hd, *flags, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, name)
    return out


def short_attention(q, k, v, causal: bool = False):
    """One-shot attention [B, H, Sq, Dh] -> [B, H, Sq, Dh]; causal needs
    Sq == Sk.

    A CPU tensor takes ``short_attention_reference``.  A CUDA tensor
    launches kernel K3 (``csrc/short_attention.cu``: bf16 on the wgmma
    tile, within ``flash_attention_bf16_tolerance``; f32 on the TF32 tile,
    three TF32 products per f32 product, within 2e-5 abs) on the current
    stream without synchronising, or raises for what it does not take.
    """
    _attention_shapes("short_attention", q, k, v, causal)
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, causal)
    out = _launch_attention("short_attention", q, k, v, int(causal))
    short_attention.launches += 1
    return out


short_attention.launches = 0


def mid_attention(q, k, v):
    """Non-causal attention over at most 4096 keys, any Sq: [B, H, Sq, Dh],
    [B, H, Sk, Dh] x 2 -> [B, H, Sq, Dh] (``flash_attention.py:201-231``).

    A CPU tensor takes ``mid_attention_reference``.  A CUDA tensor launches
    kernel K5 (``csrc/mid_attention.cu``) on the current stream without
    synchronising, or raises for what it does not take.
    """
    _attention_shapes("mid_attention", q, k, v, False)
    if k.shape[2] > _MID_MAX_KV:
        raise ValueError(f"mid_attention: {k.shape[2]} keys (K5 takes at "
                         f"most {_MID_MAX_KV})")
    if q.device.type == "cpu":
        return mid_attention_reference(q, k, v)
    out = _launch_attention("mid_attention", q, k, v)
    mid_attention.launches += 1
    return out


mid_attention.launches = 0


def flash_attention(q, k, v, causal: bool = False):
    """Blockwise attention of any length [B, H, Sq, Dh] -> [B, H, Sq, Dh];
    causal needs Sq == Sk (``flash_attention.py:97-140``).

    A CPU tensor takes ``flash_attention_reference``.  A CUDA tensor
    launches kernel K6 (``csrc/flash_attention.cu``) on the current stream
    without synchronising, or raises for what it does not take.
    """
    _attention_shapes("flash_attention", q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    out = _launch_attention("flash_attention", q, k, v, int(causal))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention_route(B: int, H: int, Sq: int, Sk: int,
                    causal: bool = False) -> str:
    """Which function ``attention`` calls: the JAX package's rule
    (``flash_attention.py:163-178``) without its TPU test -- "short" (K3)
    for Sk <= 640, "mid" (K5) for non-causal Sk <= 4096, "flash" (K6) when
    the f32 logits B*H*Sq*Sk*4 would pass 4e9 bytes, else "reference"."""
    if Sk <= _SHORT_MAX_KV:
        return "short"
    if not causal and Sk <= _MID_MAX_KV:
        return "mid"
    if B * H * Sq * Sk * 4 > _FLASH_MIN_LOGITS_BYTES:
        return "flash"
    return "reference"


def attention(q, k, v, causal: bool = False):
    """Shape-dispatched attention [B, H, Sq, Dh] -> [B, H, Sq, Dh]
    (``flash_attention.py:163-178``), by ``attention_route``.  The route
    does not depend on the device; the tensor's device decides between a
    kernel and its plain version."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(
            f"causal attention requires Sq == Sk (kernel masks have no "
            f"length offset); got Sq={q.shape[2]} Sk={k.shape[2]}")
    B, H, Sq, _ = q.shape
    route = attention_route(B, H, Sq, k.shape[2], causal)
    if route == "short":
        return short_attention(q, k, v, causal=causal)
    if route == "mid":
        return mid_attention(q, k, v)
    if route == "flash":
        return flash_attention(q, k, v, causal=causal)
    return reference_attention(q, k, v, causal=causal)


def attention_from_qkv(qkv, heads: int, causal: bool = False):
    """Attention straight from the fused qkv projection [B, S, 3*D] ->
    [B, S, D] (``flash_attention.py:244-260``).

    K1 where ``use_fused_qkv_attention`` allows; otherwise the heads are
    split ([B, S, 3, H, hd] -> three contiguous [B, H, S, hd]) and
    ``attention`` dispatches.  A CPU tensor takes the plain versions on
    the same route."""
    B, S, threeD = qkv.shape
    hd = threeD // 3 // heads
    if use_fused_qkv_attention(S, heads, hd, causal):
        return short_attention_qkv(qkv, heads)
    q, k, v = (t.contiguous() for t in _split_heads(qkv, heads))
    att = attention(q, k, v, causal=causal)
    return att.transpose(1, 2).reshape(B, S, threeD // 3)


# --------------------------------------------------------------------------
# tensor-parallel attention (one rank of an mp group)
#
# A column-parallel qkv projection gives each of mp ranks 3*D/mp output
# columns.  In the [q | k | v] layout a rank's chunk is not head-aligned,
# so the weight's columns are permuted into the head-blocked layout
# [q_0 k_0 v_0 | q_1 k_1 v_1 | ...] (``qkv_tp_permutation``); rank s's
# chunk then holds whole heads and attention runs on it with no
# collective.  The row-parallel projection after it carries the sum.
# --------------------------------------------------------------------------

def qkv_tp_permutation(dim: int, mp: int) -> np.ndarray:
    """Column permutation [3*dim] turning the fused [q | k | v] qkv layout
    into the per-shard head-blocked layout (``flash_attention.py:277-291``):
    chunk s of the permuted columns is [q_s | k_s | v_s]."""
    if dim % mp:
        raise ValueError(f"qkv_tp_permutation: dim {dim} does not split "
                         f"over mp {mp}")
    blk = dim // mp
    return np.asarray([g * dim + s * blk + i for s in range(mp)
                       for g in range(3) for i in range(blk)], np.int64)


def attention_from_qkv_tp(qkv, heads: int, mesh, axis: str = "mp",
                          causal: bool = False):
    """Tensor-parallel ``attention_from_qkv`` on this rank's chunk of a
    head-blocked qkv (``flash_attention.py:294-318``): qkv [B, S, 3*D/mp]
    -> [B, S, D/mp], the rank's heads in global head order.  No
    collective.  ``heads`` is the whole model's count (K1 at heads/mp on
    the card)."""
    mp = mesh.shape[axis]
    if heads % mp:
        raise ValueError(f"attention_from_qkv_tp: {heads} heads do not "
                         f"split over {axis} {mp}")
    return attention_from_qkv(qkv, heads // mp, causal=causal)


# --------------------------------------------------------------------------
# K4: MMDiT joint attention from the two streams' fused qkv
# --------------------------------------------------------------------------

def use_joint_qkv_attention(seq_len: int, heads: int, head_dim: int,
                            qk_norm: bool) -> bool:
    """True when the MMDiT takes K4: the JAX package's rule
    (``flash_attention.py:591-595``) -- qk-norm on, head_dim 64, an even
    head count, S <= 4096 -- without its TPU test; the tensor's device
    decides only between kernel and plain version."""
    return (qk_norm and head_dim == 64 and heads % 2 == 0
            and seq_len <= _MID_MAX_KV)


def _stream_gammas(g_x, g_c, Sx: int, Sc: int, hd: int) -> torch.Tensor:
    """[Sx + Sc, hd] f32: each row's qk-norm gamma by its stream."""
    return torch.cat([g_x.float().expand(Sx, hd), g_c.float().expand(Sc, hd)])


def joint_normalised_qkv(qkv_x, qkv_c, heads: int, q_gamma_x, k_gamma_x,
                         q_gamma_c, k_gamma_c, eps: float = 1e-6):
    """K4's q-hat, k-hat and v in f32, [B, H, Sx+Sc, hd] over the [x | ctx]
    rows: each q and k row RMS-normalised over its head dims (eps inside
    the rsqrt) and multiplied by the gamma of its stream; q not scaled."""
    Sx, Sc = qkv_x.shape[1], qkv_c.shape[1]
    q, k, v = _split_heads(torch.cat([qkv_x, qkv_c], dim=1).float(), heads)
    hd = q.shape[-1]

    def rms(t, g):
        return t * torch.rsqrt(t.square().mean(-1, keepdim=True) + eps) * g

    return (rms(q, _stream_gammas(q_gamma_x, q_gamma_c, Sx, Sc, hd)),
            rms(k, _stream_gammas(k_gamma_x, k_gamma_c, Sx, Sc, hd)), v)


def joint_qkv_attention_reference(qkv_x, qkv_c, heads: int, q_gamma_x,
                                  k_gamma_x, q_gamma_c, k_gamma_c,
                                  eps: float = 1e-6):
    """Plain version of K4: what ``_joint_qkv_kernel`` computes, in f32 --
    over the [x | ctx] rows (x first), RMS-normalise each q and k row over
    its head dims (eps inside the rsqrt), multiply by the gamma of the
    row's stream, scale q by 1/sqrt(hd), softmax over all keys, P @ V
    divided by the row sum -- cast back to the input dtype.  The
    normalised q and k stay f32 (the composed ``joint_qkv_reference``
    rounds them to the input dtype).  [B, Sx, 3D], [B, Sc, 3D] ->
    [B, Sx+Sc, D]."""
    B, Sx, threeD = qkv_x.shape
    Sc = qkv_c.shape[1]
    D = threeD // 3
    q, k, v = joint_normalised_qkv(qkv_x, qkv_c, heads, q_gamma_x,
                                   k_gamma_x, q_gamma_c, k_gamma_c, eps)
    q = q * (1.0 / math.sqrt(D // heads))
    logits = q @ k.transpose(-1, -2)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (p @ v) / p.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2).reshape(B, Sx + Sc, D).to(qkv_x.dtype)


def joint_qk_norm_reference(qkv_x, qkv_c, heads: int, q_gamma_x,
                            k_gamma_x, q_gamma_c, k_gamma_c,
                            eps: float = 1e-6):
    """Plain version of K4's pre-pass: the joint fused rows [B, Sx+Sc, 3D],
    x rows first, in the input dtype -- each q and k head of each row RMS-
    normalised over its 64 dims in f32 (eps inside the rsqrt) and
    multiplied by its stream's gamma, unscaled, rounded once to the input
    dtype; v copied."""

    def stream(qkv, g_q, g_k):
        B, S, threeD = qkv.shape
        t = qkv.float().reshape(B, S, 3, heads, threeD // 3 // heads)
        qk = t[:, :, :2]
        g = torch.stack([g_q, g_k]).float()[:, None]   # [2, 1, hd]
        qk = qk * torch.rsqrt(qk.square().mean(-1, keepdim=True) + eps) * g
        return torch.cat([qk, t[:, :, 2:]], dim=2).reshape(B, S, threeD)

    return torch.cat([stream(qkv_x, q_gamma_x, k_gamma_x),
                      stream(qkv_c, q_gamma_c, k_gamma_c)],
                     dim=1).to(qkv_x.dtype)


def _joint_launch_args(name: str, qkv_x, qkv_c, heads: int, gammas):
    """The checks K4 and its pre-pass make on a CUDA call, then (B, Sx, Sc,
    the gammas as one f32 [4, 64] tensor on the card)."""
    if qkv_x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv_x.device}")
    B, Sx, threeD = qkv_x.shape
    Sc = qkv_c.shape[1]
    if threeD // 3 // heads != 64:
        raise NotImplementedError(
            f"{name}: head_dim {threeD // 3 // heads} (K4 takes 64)")
    # an empty ctx stream (self_qkv_dispatch) is never read
    _check_cuda_input(name, *((qkv_x, qkv_c) if Sc else (qkv_x,)))
    gam = torch.stack(gammas).to(device=qkv_x.device,
                                 dtype=torch.float32).contiguous()
    return B, Sx, Sc, gam


def _joint_shapes(name: str, qkv_x, qkv_c, heads: int) -> None:
    B, Sx, threeD = qkv_x.shape
    if (qkv_c.dim() != 3 or qkv_c.shape[0] != B or qkv_c.shape[2] != threeD
            or threeD % (3 * heads)):
        raise ValueError(f"{name}: qkv_x {tuple(qkv_x.shape)} and qkv_c "
                         f"{tuple(qkv_c.shape)} are not [B, S, 3*D] with D "
                         f"divisible by {heads}")


def joint_qk_norm(qkv_x, qkv_c, heads: int, q_gamma_x, k_gamma_x,
                  q_gamma_c, k_gamma_c, eps: float = 1e-6):
    """K4's pre-pass alone: the joint fused rows [B, Sx+Sc, 3D] with the
    per-stream qk-norm applied (``joint_qk_norm_reference``).

    A CPU tensor takes ``joint_qk_norm_reference``.  A CUDA tensor launches
    the pre-pass kernel of ``csrc/joint_qkv_attention.cu`` alone, on the
    current stream without synchronising; K4 (``joint_qkv_attention``)
    launches it itself.  For checks and timing."""
    _joint_shapes("joint_qk_norm", qkv_x, qkv_c, heads)
    gammas = (q_gamma_x, k_gamma_x, q_gamma_c, k_gamma_c)
    if qkv_x.device.type == "cpu":
        return joint_qk_norm_reference(qkv_x, qkv_c, heads, *gammas, eps=eps)
    B, Sx, Sc, gam = _joint_launch_args("joint_qk_norm", qkv_x, qkv_c,
                                        heads, gammas)
    fused = torch.empty(B, Sx + Sc, qkv_x.shape[2], dtype=qkv_x.dtype,
                        device=qkv_x.device)
    rc = _build.kernels().joint_qk_norm_launch(
        qkv_x.data_ptr(), qkv_c.data_ptr() if Sc else None, gam.data_ptr(),
        fused.data_ptr(), B, Sx, Sc, heads, eps,
        int(qkv_x.dtype == torch.bfloat16),
        torch.cuda.current_stream(qkv_x.device).cuda_stream)
    _build.check(rc, "joint_qk_norm")
    joint_qk_norm.launches += 1
    return fused


joint_qk_norm.launches = 0


def joint_qkv_attention(qkv_x, qkv_c, heads: int, q_gamma_x, k_gamma_x,
                        q_gamma_c, k_gamma_c, eps: float = 1e-6):
    """MMDiT joint attention with per-stream RMS qk-norm:
    qkv_x [B, Sx, 3D], qkv_c [B, Sc, 3D] (Sc may be 0), gammas [hd] ->
    [B, Sx+Sc, D] with x rows first.

    A CPU tensor takes ``joint_qkv_attention_reference``.  A CUDA tensor
    launches kernel K4 (``csrc/joint_qkv_attention.cu``: the qk-norm
    pre-pass into scratch joint fused rows, then the attention tile on
    them; bf16 on the TMA tile, held to
    ``joint_qkv_attention_bf16_reference`` by
    ``joint_qkv_attention_bf16_tolerance``; f32 on the TF32 tile, within
    2e-5 abs) on the current stream without synchronising, or raises for
    what it does not take (head_dim other than 64, another dtype, a
    non-contiguous or misaligned stream)."""
    _joint_shapes("joint_qkv_attention", qkv_x, qkv_c, heads)
    gammas = (q_gamma_x, k_gamma_x, q_gamma_c, k_gamma_c)
    if qkv_x.device.type == "cpu":
        return joint_qkv_attention_reference(qkv_x, qkv_c, heads, *gammas,
                                             eps=eps)
    B, Sx, Sc, gam = _joint_launch_args("joint_qkv_attention", qkv_x, qkv_c,
                                        heads, gammas)
    threeD = qkv_x.shape[2]
    fused = torch.empty(B, Sx + Sc, threeD, dtype=qkv_x.dtype,
                        device=qkv_x.device)
    out = torch.empty(B, Sx + Sc, threeD // 3, dtype=qkv_x.dtype,
                      device=qkv_x.device)
    rc = _build.kernels().joint_qkv_attention_launch(
        qkv_x.data_ptr(), qkv_c.data_ptr() if Sc else None, gam.data_ptr(),
        fused.data_ptr(), out.data_ptr(), B, Sx, Sc, heads, eps,
        int(qkv_x.dtype == torch.bfloat16),
        torch.cuda.current_stream(qkv_x.device).cuda_stream)
    _build.check(rc, "joint_qkv_attention")
    joint_qkv_attention.launches += 1
    return out


joint_qkv_attention.launches = 0


def joint_qkv_attention_bf16_reference(qkv_x, qkv_c, heads: int, q_gamma_x,
                                       k_gamma_x, q_gamma_c, k_gamma_c,
                                       eps: float = 1e-6):
    """Plain version of K4's bf16 path, [B, Sx+Sc, D] f32: q-hat and k-hat
    of ``joint_normalised_qkv`` rounded to bf16, as K4's pre-pass and the
    JAX package's composed ``joint_qkv_reference`` round them (the
    Pallas K4 and ``joint_qkv_attention_reference`` keep them in f32), then
    ``flash_attention_reference`` in f32 with P unrounded."""
    B, Sx, threeD = qkv_x.shape
    q, k, v = joint_normalised_qkv(qkv_x, qkv_c, heads, q_gamma_x, k_gamma_x,
                                   q_gamma_c, k_gamma_c, eps)
    out = flash_attention_reference(q.to(torch.bfloat16).float(),
                                    k.to(torch.bfloat16).float(), v)
    return out.transpose(1, 2).reshape(B, Sx + qkv_c.shape[1], threeD // 3)


# how far K4's f32 q-hat and k-hat may lie from the plain version's, as a
# fraction of the value, with a factor 2 to spare (see
# joint_qkv_attention_bf16_tolerance)
_NORM_REL = 2.0 ** -16


def _rounding_flips(x):
    """2^-7 |x|, at least one bf16 ulp, where x lies within ``_NORM_REL``
    |x| of a bf16 rounding midpoint, so that x computed in another order
    may round to the neighbour; else 0."""
    to_mid = _bf16_ulp(x) / 2 - (x - x.to(torch.bfloat16).float()).abs()
    return torch.where(to_mid <= _NORM_REL * x.abs(), 2.0 ** -7 * x.abs(),
                       torch.zeros_like(x))


def joint_qkv_attention_bf16_tolerance(qkv_x, qkv_c, heads: int, q_gamma_x,
                                       k_gamma_x, q_gamma_c, k_gamma_c, want,
                                       eps: float = 1e-6):
    """Elementwise bound on |out - want| [B, Sx+Sc, D] for K4
    ``joint_qkv_attention`` on bf16 inputs, want being
    ``joint_qkv_attention_bf16_reference`` on the same arguments.

    K4's pre-pass computes q-hat and k-hat in f32 and rounds them to bf16,
    and its tile is that of K5 and K6 on them, so the bound is
    ``flash_attention_bf16_tolerance`` on the rounded q-hat, k-hat and v,
    plus a term for q-hat and k-hat rounding otherwise than the plain
    version's.  With u = 2^-8, bf16's unit roundoff:

    - the pre-pass's f32 value of an element x of q-hat or k-hat (its own
      order for the 64 squares, rsqrtf) lies within 2^-17 |x| of the plain
      version's: 63 * 2^-24 on the sum of squares in either order, halved
      by the rsqrt, plus rsqrtf's two ulps and two products;
    - so the two round x alike unless x lies within 2^-16 |x| of a bf16
      rounding midpoint; there they may round to neighbours, at most
      F = 2^-7 |x| apart;
    - those flips move the logit s_ij by at most e_ij = scale (F_q (|k| +
      F_k) + |q| F_k)_ij, so p_ij by a factor within 1 +- r_ij, r_ij =
      max(e^e_ij / Z-_i - 1, 1 - e^-e_ij / Z+_i) with Z+-_i = sum_j p_ij
      e^(+-e_ij), and the p rounded to bf16 by u (1 + r_ij) p_ij.

    The bound is ``flash_attention_bf16_tolerance`` plus (1 + u) sum_j
    p_ij r_ij |v_j|, which is 0 where no element lies near a midpoint.
    The logits are built in chunks of B*H of at most
    ``_PLAIN_LOGITS_BYTES`` each."""
    B, Sx, threeD = qkv_x.shape
    S = Sx + qkv_c.shape[1]
    D = threeD // 3
    hd = D // heads
    qf, kf, v = joint_normalised_qkv(qkv_x, qkv_c, heads, q_gamma_x,
                                     k_gamma_x, q_gamma_c, k_gamma_c, eps)
    q, k = qf.to(torch.bfloat16).float(), kf.to(torch.bfloat16).float()
    tol = flash_attention_bf16_tolerance(
        q, k, v, want.reshape(B, S, heads, hd).transpose(1, 2))
    q, k, v, fq, fk = (t.reshape(B * heads, S, hd) for t in (
        q, k, v, _rounding_flips(qf), _rounding_flips(kf)))
    scale = 1.0 / math.sqrt(hd)
    per = max(1, int(_PLAIN_LOGITS_BYTES // (4 * S * S)))
    flips = []
    for i in range(0, B * heads, per):
        n = slice(i, i + per)
        p = torch.softmax((q[n] @ k[n].transpose(-1, -2)) * scale, dim=-1)
        e = scale * (fq[n] @ (k[n].abs() + fk[n]).transpose(-1, -2)
                     + q[n].abs() @ fk[n].transpose(-1, -2))
        up, down = torch.exp(e), torch.exp(-e)
        r = torch.maximum(up / (p * down).sum(-1, keepdim=True) - 1,
                          1 - down / (p * up).sum(-1, keepdim=True))
        flips.append((p * r) @ v[n].abs())
        del p, e, up, down, r
    flips = torch.cat(flips).reshape(B, heads, S, hd)
    return (tol + (1 + _BF16_U) * flips).transpose(1, 2).reshape(B, S, D)


def joint_qkv_reference(qkv_x, qkv_c, heads: int, q_gamma_x, k_gamma_x,
                        q_gamma_c, k_gamma_c, eps: float = 1e-6):
    """The composed joint attention (``flash_attention.py:598-626``): split
    heads, RMS qk-norm rounded back to the input dtype (gammas None: no
    norm), ``reference_attention`` over [x | ctx] rows."""
    B, Sx, threeD = qkv_x.shape
    Sc = qkv_c.shape[1]
    D = threeD // 3

    def rms(t, g):
        if g is None:
            return t
        tf = t.float()
        return (tf * torch.rsqrt(tf.square().mean(-1, keepdim=True) + eps)
                * g.float()).to(t.dtype)

    qx, kx, vx = _split_heads(qkv_x, heads)
    qc, kc, vc = _split_heads(qkv_c, heads)
    q = torch.cat([rms(qx, q_gamma_x), rms(qc, q_gamma_c)], dim=2)
    k = torch.cat([rms(kx, k_gamma_x), rms(kc, k_gamma_c)], dim=2)
    v = torch.cat([vx, vc], dim=2)
    out = reference_attention(q, k, v)
    return out.transpose(1, 2).reshape(B, Sx + Sc, D)


def joint_qkv_dispatch(qkv_x, qkv_c, heads: int, q_gamma_x, k_gamma_x,
                       q_gamma_c, k_gamma_c, eps: float = 1e-6):
    """K4 where ``use_joint_qkv_attention`` allows, else the composed
    ``joint_qkv_reference`` (gammas None: qk-norm off), as
    ``flash_attention.py:629-641``."""
    hd = qkv_x.shape[-1] // 3 // heads
    fn = (joint_qkv_attention
          if use_joint_qkv_attention(qkv_x.shape[1] + qkv_c.shape[1], heads,
                                     hd, q_gamma_x is not None)
          else joint_qkv_reference)
    return fn(qkv_x, qkv_c, heads, q_gamma_x, k_gamma_x, q_gamma_c,
              k_gamma_c, eps=eps)


def self_qkv_dispatch(qkv, heads: int, q_gamma, k_gamma, eps: float = 1e-6):
    """Self-attention with RMS qk-norm from one fused qkv [B, S, 3D]: the
    joint dispatch with an empty ctx stream (the MMDiT-X dual-attention
    branch, ``flash_attention.py:644-654``)."""
    return joint_qkv_dispatch(qkv, qkv[:, :0], heads, q_gamma, k_gamma,
                              q_gamma, k_gamma, eps=eps)


def joint_qkv_attention_tp(qkv_x, qkv_c, heads: int, q_gamma_x, k_gamma_x,
                           q_gamma_c, k_gamma_c, mesh, axis: str = "mp",
                           eps: float = 1e-6):
    """Tensor-parallel MMDiT joint attention on this rank's chunks of the
    two streams' head-blocked qkv (``flash_attention.py:657-700``): [B, Sx,
    3*D/mp] and [B, Sc, 3*D/mp] -> [B, Sx+Sc, D/mp].  ``joint_qkv_dispatch``
    on heads/mp heads with the replicated gammas (None: no qk-norm, the
    composed path); K4 on the card.  No collective."""
    mp = mesh.shape[axis]
    if heads % mp:
        raise ValueError(f"joint_qkv_attention_tp: {heads} heads do not "
                         f"split over {axis} {mp}")
    return joint_qkv_dispatch(qkv_x, qkv_c, heads // mp, q_gamma_x,
                              k_gamma_x, q_gamma_c, k_gamma_c, eps=eps)
