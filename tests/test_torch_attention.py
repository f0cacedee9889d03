"""Port parity: fused-QKV attention (kernel K1) and its plain version
against bsc_nav_tpu/ops/flash_attention.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import flash_attention as jfa
from bsc_nav_tpu_torch.ops import flash_attention as tfa


def _qkv(B, S, heads, hd, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, S, 3 * heads * hd)).astype(np.float32)


@pytest.mark.parametrize("S", [37, 261])
def test_short_attention_qkv_plain_matches_pallas_interpret(S):
    # f32 both sides; sums in another order: 1e-5 abs on O(1) outputs
    qkv = _qkv(2, S, 4, 64)
    want = np.asarray(jfa.short_attention_qkv(jnp.asarray(qkv), heads=4,
                                              interpret=True))
    got = tfa.short_attention_qkv(torch.from_numpy(qkv), heads=4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_from_qkv_matches_jax(causal):
    # JAX on the CPU takes its split/transpose reference path; 1e-5 abs
    qkv = _qkv(2, 29, 2, 16, seed=1)
    want = np.asarray(jfa.attention_from_qkv(jnp.asarray(qkv), heads=2,
                                             causal=causal))
    got = tfa.attention_from_qkv(torch.from_numpy(qkv), heads=2,
                                 causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_reference_attention_matches_jax():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 3, 19, 32)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jfa.reference_attention(*map(jnp.asarray, (q, k, v))))
    got = tfa.reference_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_kernel_gate():
    assert tfa.kernel_supports(64) and tfa.kernel_supports(16)
    assert tfa.kernel_supports(128) and tfa.kernel_supports(80)
    assert not tfa.kernel_supports(64, causal=True)
    assert not tfa.kernel_supports(160) and not tfa.kernel_supports(40)
