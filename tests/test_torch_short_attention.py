"""Port parity: K3 ``short_attention``'s plain version and the attention
dispatch against bsc_nav_tpu/ops/flash_attention.py.

The JAX kernel runs in Pallas interpret mode, as tests/test_flash_attention.py
runs it on the CPU.  The card side (the CUDA kernel against its plain
version) is in tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import flash_attention as jfa
from bsc_nav_tpu_torch.ops import flash_attention as tfa


def _bhsd(B, H, S, hd, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, H, S, hd)).astype(np.float32)


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,hd,causal", [(77, 64, True), (77, 80, False),
                                         (257, 80, False), (257, 64, True)])
def test_short_attention_plain_matches_pallas_interpret(S, hd, causal,
                                                        dtype):
    """f32: the same function, sums in another order: 1e-5 abs on O(1)
    outputs.  bf16 (the same bf16 inputs on both sides): each side rounds
    an f32 result within 1e-5 of the other's to bf16 once, so they differ
    by at most 1e-5 plus one bf16 ulp at the output's magnitude."""
    q, k, v = (_bhsd(2, 2, S, hd, s) for s in (1, 2, 3))
    jd = getattr(jnp, dtype)
    want = np.asarray(jfa.short_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal,
        interpret=True).astype(jnp.float32))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = tfa.short_attention(tq, tk, tv, causal=causal)
    assert got.dtype == td and got.shape == (2, 2, S, hd)
    got = got.float().numpy()
    tol = 1e-5 + (_bf16_ulp(want) if dtype == "bfloat16" else 0.0)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def test_short_attention_ragged_kv_matches_pallas_interpret():
    """Sq != Sk, neither a multiple of 8 (the TPU kernel pads both and
    masks keys >= kv_len): 1e-5 abs."""
    q, k, v = _bhsd(1, 3, 50, 80, 4), _bhsd(1, 3, 203, 80, 5), \
        _bhsd(1, 3, 203, 80, 6)
    want = np.asarray(jfa.short_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True))
    got = tfa.short_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,hd", [(2, 80), (2, 64)])
def test_attention_from_qkv_matches_jax_at_clip_head_dims(heads, hd, causal):
    """The CLIP towers' route (split heads, then ``attention``) against the
    JAX package's off-TPU path: 1e-5 abs."""
    rng = np.random.default_rng(7)
    qkv = rng.normal(size=(2, 77, 3 * heads * hd)).astype(np.float32)
    want = np.asarray(jfa.attention_from_qkv(jnp.asarray(qkv), heads=heads,
                                             causal=causal))
    got = tfa.attention_from_qkv(torch.from_numpy(qkv), heads=heads,
                                 causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("S,heads,hd,causal", [
    (261, 16, 64, False),       # DINOv2 ViT-L: K1
    (257, 16, 80, False),       # MetaCLIP ViT-H vision: K3 (the old port took K1)
    (77, 16, 64, True),         # CLIP text: K3
    (640, 4, 64, False), (641, 4, 64, False),   # the S <= 640 edge
    (100, 3, 64, False),        # odd head count
    (100, 4, 32, False), (100, 4, 128, False),  # other head dims
    (1000, 16, 80, False)])     # long: K5 / K6 territory
def test_fused_qkv_gate_matches_jax(monkeypatch, S, heads, hd, causal):
    """The port takes K1 exactly where the JAX package would on a TPU.
    Before this gate, the port sent any non-causal head_dim that is a
    multiple of 16 to K1 at any S (hd 80 and S > 640 included)."""
    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    assert (tfa.use_fused_qkv_attention(S, heads, hd, causal)
            == jfa.use_fused_qkv_attention(S, heads, hd, causal))


def test_attention_dispatch_errors():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.attention(q, torch.zeros(1, 2, 9, 64), torch.zeros(1, 2, 9, 64),
                      causal=True)
    # beyond 640 keys the CPU takes the JAX package's reference path
    k = torch.from_numpy(_bhsd(1, 2, 700, 64, 8))
    got = tfa.attention(k[:, :, :5], k, k)
    torch.testing.assert_close(got, tfa.reference_attention(k[:, :, :5], k,
                                                            k))
    assert tfa.short_attention.launches == 0
