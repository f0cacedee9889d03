"""Port parity: K8 ``conv3x3_s1``'s plain version and ``fold_bn`` against
bsc_nav_tpu/ops/conv2d.py in Pallas interpret mode, with channel counts
that are not multiples of 128 (the TPU kernel compiles only those; its
interpret mode takes any).  The card side is in tests/test_torch_kernels.py.
Neither package dispatches the kernel.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import conv2d as jconv
from bsc_nav_tpu_torch.ops import conv2d as tconv


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _conv_inputs(B, H, W, C, CO, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, CO)) / np.sqrt(9 * C)).astype(np.float32)
    bias = rng.normal(size=(CO,)).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("B,H,W,C,CO,th,act,dtype", [
    (2, 8, 10, 20, 36, 4, "silu", "float32"),
    (1, 8, 8, 160, 48, 4, "silu", "float32"),      # YOLOv8x's width 160
    (1, 4, 6, 3, 70, 2, "none", "float32"),
    (2, 8, 10, 20, 36, 4, "silu", "bfloat16"),
])
def test_conv3x3_plain_matches_pallas_interpret(B, H, W, C, CO, th, act,
                                                dtype):
    """f32: the same nine tap products summed in another order: 1e-4 of
    max |out|.  bf16 (the same bf16 x and w on both sides, products exact
    in f32): that plus one bf16 ulp at the output's magnitude."""
    x, w, bias = _conv_inputs(B, H, W, C, CO, seed=C + CO)
    jd = getattr(jnp, dtype)
    want = np.asarray(jconv.conv3x3_s1(
        jnp.asarray(x, jd), jnp.asarray(w.reshape(9, C, CO), jd),
        jnp.asarray(bias), act=act, th=th, interpret=True).astype(
            jnp.float32))
    td = getattr(torch, dtype)
    got = tconv.conv3x3_s1(torch.from_numpy(x).to(td),
                           torch.from_numpy(w.reshape(9, C, CO)).to(td),
                           torch.from_numpy(bias), act=act)
    assert got.dtype == td and got.shape == (B, H, W, CO)
    got = got.float().numpy()
    tol = 1e-4 * np.abs(want).max() + (
        _bf16_ulp(want) if dtype == "bfloat16" else 0.0)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def test_fold_bn_matches_jax():
    """The folded weights and bias within 1e-6 abs, and the conv over them
    within 1e-4 of max |out| (C 96, CO 40)."""
    rng = np.random.default_rng(1)
    x, w, _ = _conv_inputs(1, 8, 8, 96, 40, seed=2)
    sc = rng.uniform(0.5, 1.5, 40).astype(np.float32)
    bi = rng.normal(size=40).astype(np.float32)
    mu = rng.normal(size=40).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    jw9, jb = jconv.fold_bn(*map(jnp.asarray, (w, sc, bi, mu, var)))
    tw9, tb = tconv.fold_bn(*map(torch.from_numpy, (w, sc, bi, mu, var)))
    assert tw9.shape == (9, 96, 40) and tb.dtype == torch.float32
    np.testing.assert_allclose(tw9.numpy(), np.asarray(jw9), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6, rtol=0)
    want = np.asarray(jconv.conv3x3_s1(jnp.asarray(x), jw9, jb, th=4,
                                       interpret=True))
    got = tconv.conv3x3_s1(torch.from_numpy(x), tw9, tb).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_conv3x3_refuses_mismatched_shapes():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="9, C, CO"):
        tconv.conv3x3_s1(x, torch.zeros(9, 7, 5), torch.zeros(5))
    with pytest.raises(ValueError, match="9, C, CO"):
        tconv.conv3x3_s1(x, torch.zeros(9, 8, 5), torch.zeros(4))
