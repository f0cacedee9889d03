"""T5 v1.1 encoder: the text conditioning the SD3.5 imagination appends
after the CLIP context.

Counterpart of ``bsc_nav_tpu/models/t5.py``: relative position bias
(bucketed, first layer only, shared), RMSNorm, gated-GELU feed-forward, no
scaling inside attention.  Parameters are a plain dict tree in the JAX
layout -- ``embed [vocab, dim]``, ``rel_bias [buckets, heads]``, per block
``ln1, q, k, v, o, ln2, wi0, wi1, wo`` (bare ``[fan_in, fan_out]``
matrices, or ``{"w_q", "w_s"}`` int8 leaves once quantized) and
``ln_final`` -- so the ``.npz`` that ``save_params_npz`` writes loads key for
key (``models.weights``).  T5's attention is an einsum with a bias in the
JAX package, not a Pallas kernel, so it is plain torch matmuls here; the
int8 leaves go through ``ops.quant.linear_q8`` (``torch._int_mm`` on the
card).  Text -> ids is ``models.sentencepiece``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bsc_nav_tpu_torch import resolve_device
from bsc_nav_tpu_torch.ops.quant import (linear_q8, quantize_weight,
                                         weight_scale)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    dim: int = 4096                 # d_model (t5-xxl)
    d_kv: int = 64
    heads: int = 64
    d_ff: int = 10240
    layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6


T5_XXL = T5Config()
T5_TEST = T5Config(vocab_size=256, dim=64, d_kv=16, heads=4, d_ff=128,
                   layers=2)

#: per-block weights carrying the token-matmul FLOPs (``t5.py:159``)
QUANT_KEYS = ("q", "k", "v", "o", "wi0", "wi1", "wo")


@torch.no_grad()
def init_params(cfg: T5Config, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Random weights with the JAX package's distributions (``t5.py:47-74``:
    linears N(0, 1/fan_in), embedding N(0, 1), position bias N(0, 0.01),
    unit norms).  ``generator`` must live on ``device``; the draws do not
    reproduce jax.random."""
    dev = resolve_device(device)
    inner = cfg.heads * cfg.d_kv

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    def lin(fi, fo):
        return normal((fi, fo), 1.0 / math.sqrt(fi))

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    blocks = [{"ln1": ones(cfg.dim), "q": lin(cfg.dim, inner),
               "k": lin(cfg.dim, inner), "v": lin(cfg.dim, inner),
               "o": lin(inner, cfg.dim), "ln2": ones(cfg.dim),
               "wi0": lin(cfg.dim, cfg.d_ff), "wi1": lin(cfg.dim, cfg.d_ff),
               "wo": lin(cfg.d_ff, cfg.dim)} for _ in range(cfg.layers)]
    return {"embed": normal((cfg.vocab_size, cfg.dim), 1.0),
            "rel_bias": normal((cfg.rel_buckets, cfg.heads), 0.1),
            "blocks": blocks,
            "ln_final": ones(cfg.dim)}


def quantize_params_host(params: Dict[str, Any]) -> Dict[str, Any]:
    """int8 tree from a numpy tree, on the host before upload
    (``t5.py:116-134``): the QUANT_KEYS matrices and the embedding table
    get a per-column scale max|w| / 127; the rest passes through."""
    def qw(w):
        w = np.asarray(w, np.float32)
        s = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
        return {"w_q": np.round(w / s).astype(np.int8),
                "w_s": s.astype(np.float32)}

    out = {k: v for k, v in params.items() if k not in ("blocks", "embed")}
    out["blocks"] = [
        {k: (qw(v) if k in QUANT_KEYS else v) for k, v in blk.items()}
        for blk in params["blocks"]]
    out["embed"] = qw(params["embed"])
    return out


@torch.no_grad()
def quantize_params(params: Dict[str, Any],
                    quantize_embed: bool = True) -> Dict[str, Any]:
    """int8 W8A8 on the device (``t5.py:162-186``): the QUANT_KEYS
    matrices, and the embedding table with a per-column scale."""
    out = {k: v for k, v in params.items() if k not in ("blocks", "embed")}
    out["blocks"] = [
        {k: (quantize_weight({"w": v}) if k in QUANT_KEYS else v)
         for k, v in blk.items()}
        for blk in params["blocks"]]
    if quantize_embed:
        e = params["embed"].to(torch.float32)
        s = weight_scale(e.abs().amax(dim=0))
        out["embed"] = {"w_q": torch.round(e / s).to(torch.int8), "w_s": s}
    else:
        out["embed"] = params["embed"]
    return out


def _rms_norm(x, w, eps):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """Weight-dispatching matmul: a bare [fi, fo] matrix runs in the
    promoted dtype; an int8 leaf runs W8A8 (``t5.py:143-155``, no bias)."""
    if isinstance(w, dict):
        return linear_q8(x, w)
    ct = torch.promote_types(x.dtype, w.dtype)
    return x.to(ct) @ w.to(ct)


def _relative_buckets(rel_pos: torch.Tensor, num_buckets: int,
                      max_distance: int) -> torch.Tensor:
    """T5 bidirectional relative position bucketing (``t5.py:189-201``)."""
    nb = num_buckets // 2
    bucket = torch.where(rel_pos > 0, nb, 0)
    n = rel_pos.abs()
    max_exact = nb // 2
    large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-9)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return bucket + torch.where(n < max_exact, n, large)


def _position_bias(params, cfg: T5Config, S: int) -> torch.Tensor:
    """[1, H, S, S] bias from the shared bucket table."""
    pos = torch.arange(S, device=params["rel_bias"].device)
    buckets = _relative_buckets(pos[None, :] - pos[:, None], cfg.rel_buckets,
                                cfg.rel_max_distance)
    return params["rel_bias"][buckets].permute(2, 0, 1)[None]


@torch.no_grad()
def encode(params: Dict[str, Any], token_ids: torch.Tensor, cfg: T5Config,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """token_ids [B, S] -> sequence features [B, S, dim] (``t5.py:213-250``).
    An int8 embedding table dequantizes to bf16, as quantized serving does
    in the JAX package."""
    B, S = token_ids.shape
    emb = params["embed"]
    ids = token_ids.to(device=params["rel_bias"].device, dtype=torch.long)
    if isinstance(emb, dict):
        x = (emb["w_q"][ids].to(torch.float32) * emb["w_s"]).to(
            torch.bfloat16)
    else:
        x = emb[ids]
    bias = _position_bias(params, cfg, S)
    if mask is not None:
        bias = bias + torch.where(mask[:, None, None, :], 0.0, -1e9)

    def heads(t):
        return t.reshape(B, S, cfg.heads, cfg.d_kv).transpose(1, 2)

    for blk in params["blocks"]:
        y = _rms_norm(x, blk["ln1"], cfg.eps)
        q, k, v = (heads(_mm(y, blk[n])) for n in ("q", "k", "v"))
        logits = q.float() @ k.float().transpose(-1, -2) + bias
        att = torch.softmax(logits, dim=-1).to(v.dtype)
        out = att.float() @ v.float()
        out = out.transpose(1, 2).reshape(B, S, -1).to(x.dtype)
        x = x + _mm(out, blk["o"]).to(x.dtype)

        y = _rms_norm(x, blk["ln2"], cfg.eps)
        h = (F.gelu(_mm(y, blk["wi0"]), approximate="tanh")
             * _mm(y, blk["wi1"]))
        x = x + _mm(h, blk["wo"]).to(x.dtype)

    return _rms_norm(x, params["ln_final"], cfg.eps)
