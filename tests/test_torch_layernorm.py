"""Port parity: K7 ``layer_norm``'s plain version against
bsc_nav_tpu/ops/layernorm.py ``layer_norm_tpu`` in Pallas interpret mode, at
the shapes of tests/test_layernorm.py.  The card side is in
tests/test_torch_kernels.py.  Neither package dispatches the kernel: the
ViTs normalise with jnp / ``F.layer_norm``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops.layernorm import layer_norm_tpu
from bsc_nav_tpu_torch.ops import layernorm as tln


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape,dtype,bm", [
    ((4, 261, 1024), "float32", 256),      # ViT-L token grid
    ((2, 77, 1280), "float32", 256),       # CLIP-H text (M=154 < bm pad)
    ((3, 128), "bfloat16", 64),            # rank-2, bf16
    ((1, 1101, 1536), "float32", 384),     # MMDiT joint stream
    ((4, 261, 1024), "bfloat16", 256),
])
def test_layer_norm_plain_matches_pallas_interpret(shape, dtype, bm):
    """Rows of mean 1 and std 3 normalise to unit scale before the affine
    (scale and bias N(0, 1)).  f32: the same centred two-pass statistics,
    sums in another order: 1e-5 abs.  bf16 (the same bf16 input on both
    sides): 1e-5 plus one bf16 ulp at the output's magnitude."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    d = shape[-1]
    scale = rng.normal(size=(d,)).astype(np.float32)
    bias = rng.normal(size=(d,)).astype(np.float32)
    want = np.asarray(layer_norm_tpu(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(scale),
        jnp.asarray(bias), eps=1e-6, bm=bm, interpret=True).astype(
            jnp.float32))
    td = getattr(torch, dtype)
    got = tln.layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(scale),
                         torch.from_numpy(bias), eps=1e-6)
    assert got.dtype == td and got.shape == shape
    got = got.float().numpy()
    tol = 1e-5 + (_bf16_ulp(want) if dtype == "bfloat16" else 0.0)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def test_layer_norm_takes_any_width_and_centres_its_variance():
    """D = 37 (the TPU kernel needs D % 128 == 0) against F.layer_norm in
    f64 on the same f32 rows of mean 100 and std 1e-2, where a one-pass
    E[x^2] - mean^2 in f32 gives a variance of 0 or -1e-3 and outputs off
    by thousands: 5e-3 abs on unit outputs (the f32 mean of 37 values
    near 100 is exact to ~1e-5, 1e-3 of the std)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=(5, 37)) * 1e-2 + 1e2).astype(
        np.float32))
    g, b = (torch.from_numpy(rng.normal(size=37).astype(np.float32))
            for _ in range(2))
    got = tln.layer_norm(x, g, b, eps=1e-12)
    want = torch.nn.functional.layer_norm(x.double(), (37,), g.double(),
                                          b.double(), 1e-12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-3, rtol=0)
    with pytest.raises(ValueError, match="not \\[37\\]"):
        tln.layer_norm(x, g[:8], b)
