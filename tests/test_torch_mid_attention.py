"""Port parity: K5 ``mid_attention``'s plain version against
bsc_nav_tpu/ops/flash_attention.py ``mid_attention``.

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
@pytest.mark.parametrize("B,H,Sq,Sk,hd", [
    (1, 2, 700, 1030, 64),      # ragged: neither a multiple of the q tile
    (2, 1, 641, 641, 80),       # just past K3's 640 keys, square
    (1, 1, 37, 4096, 16)])      # K5's longest
def test_mid_attention_plain_matches_pallas_interpret(B, H, Sq, Sk, hd,
                                                      dtype):
    """f32: the same function, sums in another order: 1e-5 abs on O(1)
    outputs.  bf16 (the same bf16 inputs on both sides): each side rounds
    an f32 result within 1e-5 of the other's to bf16 once, so they differ
    by at most 1e-5 plus one bf16 ulp at the output's magnitude."""
    q, k, v = _bhsd(B, H, Sq, hd, 1), _bhsd(B, H, Sk, hd, 2), \
        _bhsd(B, H, Sk, hd, 3)
    jd = getattr(jnp, dtype)
    want = np.asarray(jfa.mid_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), interpret=True).astype(
            jnp.float32))
    td = getattr(torch, dtype)
    got = tfa.mid_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert got.dtype == td and got.shape == (B, H, Sq, hd)
    got = got.float().numpy()
    tol = 1e-5 + (_bf16_ulp(want) if dtype == "bfloat16" else 0.0)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def test_mid_attention_plain_chunks_over_heads(monkeypatch):
    """The plain version builds its logits in chunks of B*H: with a chunk
    of one (batch, head) it makes six calls and returns the unchunked
    result within 1e-6 (the same sums, batched differently)."""
    q, k = (torch.from_numpy(_bhsd(2, 3, S, 16, s))
            for S, s in ((50, 4), (700, 5)))
    whole = tfa.mid_attention_reference(q, k, k)
    calls = []
    real = tfa.short_attention_reference
    monkeypatch.setattr(tfa, "short_attention_reference",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(tfa, "_PLAIN_LOGITS_BYTES", 4 * 50 * 700)
    torch.testing.assert_close(tfa.mid_attention_reference(q, k, k), whole,
                               rtol=0, atol=1e-6)
    assert len(calls) == 6


def test_mid_attention_refuses_past_4096_keys():
    q, k = torch.zeros(1, 1, 4, 16), torch.zeros(1, 1, 4097, 16)
    with pytest.raises(ValueError, match="at most 4096"):
        tfa.mid_attention(q, k, k)
    with pytest.raises(ValueError, match="shapes"):
        tfa.mid_attention(q, k, k[..., :8])
