"""Plain building blocks of the references: resampling, layer norm,
attention and GELU in float32 with TF32 off.  No kernel, no cache, no
batching beyond what the inputs bring; nothing of the program."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def full_f32():
    """Every f32 product inside in full f32 (TF32 off), the flags put
    back on exit."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] antialiased bilinear resampling along one axis: a
    triangle kernel widened by the scale when shrinking, each output's
    weights renormalised to sum to one (jax.image.resize's 'bilinear')."""
    f = np.float32
    inv = f(1.0) / f(n_out / n_in)
    width = max(inv, f(1.0))
    centre = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.5)
    x = np.abs(centre[None, :] - np.arange(n_in, dtype=f)[:, None]) / width
    w = np.maximum(0, 1 - x).astype(f)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f)


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] float -> [B, size, size, C]."""
    B, H, W, C = images.shape
    if (H, W) == (size, size):
        return images
    wh = torch.from_numpy(resize_matrix(H, size)).to(images.device)
    ww = torch.from_numpy(resize_matrix(W, size)).to(images.device)
    return torch.einsum("bhwc,hH,wW->bHWc", images, wh, ww)


def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (x + 0.044715 * x ** 3)))


def gelu_erf(x):
    return 0.5 * x * (1 + torch.erf(x / math.sqrt(2)))


def activation(c):
    """The MLP activation a configuration states: ``gelu_exact`` the erf
    form, else tanh GELU."""
    return gelu_erf if c["gelu_exact"] else gelu_tanh


def attention(qkv: torch.Tensor, heads: int):
    """[B, S, 3D] fused q|k|v -> [B, S, D]: softmax(q k^T / sqrt(hd)) v."""
    B, S, D3 = qkv.shape
    D = D3 // 3
    hd = D // heads
    q, k, v = (t.reshape(B, S, heads, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    p = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    return (p @ v).transpose(1, 2).reshape(B, S, D)


def patches(images: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, T, p*p*3], each patch's pixels row by row and
    its channels innermost."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def linear(x, w, b=None):
    y = x @ w
    return y + b if b is not None else y
