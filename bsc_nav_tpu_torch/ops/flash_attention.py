"""Attention for the ViT encoder: kernel K1 and its plain version.

Counterpart of ``bsc_nav_tpu/ops/flash_attention.py``.  Only the path the
memory spine runs is ported: ``attention_from_qkv`` -> ``short_attention_qkv``
(the fused-QKV kernel, ``csrc/short_attention_qkv.cu``).  The other TPU
kernels of that module -- ``short_attention`` (K3), ``joint_qkv_attention``
(K4), ``mid_attention`` (K5) and ``flash_attention`` (K6) -- are queued in
ROADMAP.md; on a CUDA tensor a call that would need them raises.

Layouts follow the JAX package: ``reference_attention`` takes
[B, H, S, Dh]; the fused-QKV functions take [B, S, 3*D] (q | k | v
column groups, heads contiguous inside each group) and return [B, S, D].
"""

from __future__ import annotations

import math

import torch

from bsc_nav_tpu_torch.ops import _build

_NEG_INF = -1e30


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
    """K1's gate: non-causal, head_dim a multiple of 16 up to 128.  Any
    head count and any sequence length (the kernel streams K/V tiles)."""
    return not causal and head_dim % 16 == 0 and 16 <= head_dim <= 128


def short_attention_qkv(qkv, heads: int):
    """Fused-QKV attention [B, S, 3*D] -> [B, S, D].

    A CPU tensor takes ``short_attention_qkv_reference``.  A CUDA tensor
    launches kernel K1 (``csrc/short_attention_qkv.cu``) on the current
    stream without synchronising, or raises for what it does not take.
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


def attention_from_qkv(qkv, heads: int, causal: bool = False):
    """Attention straight from the fused qkv projection [B, S, 3*D] ->
    [B, S, D] (``flash_attention.py:244``).

    CUDA: kernel K1 when its gate allows; anything else (causal, head_dim
    over 128 or not a multiple of 16) raises ``NotImplementedError``
    naming the TPU kernels K3/K5/K6 still to be ported -- there is no
    quiet plain path on the card.  CPU: the plain versions."""
    B, S, threeD = qkv.shape
    hd = threeD // 3 // heads
    if qkv.device.type == "cpu":
        if not causal:
            return short_attention_qkv(qkv, heads)
        q, k, v = _split_heads(qkv, heads)
        att = reference_attention(q, k, v, causal=True)
        return att.transpose(1, 2).reshape(B, S, threeD // 3)
    if not kernel_supports(hd, causal):
        raise NotImplementedError(
            f"attention_from_qkv(causal={causal}, head_dim={hd}) on "
            f"{qkv.device} needs a kernel not ported yet (K3 short_attention,"
            " K5 mid_attention or K6 flash_attention; see ROADMAP.md)")
    return short_attention_qkv(qkv, heads)
