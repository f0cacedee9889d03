"""K8's f32 path on the tensor cores (three TF32 products per product,
bsc_nav_tpu_torch/csrc/conv3x3_s1.cu) emulated on the CPU
(``torch_parity.tf32x3_conv``: its order of products and sums, the
tensor cores' truncating accumulation included) against the Pallas
``conv3x3_s1`` in interpret mode and the port's plain version, under the
unchanged f32 bound K8_TOL: 1e-4 of max |out|.  A lost tap and one TF32
product per product must break that bound.  The kernel itself runs only
on the card (tests/test_torch_kernels.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import conv2d as jconv
from bsc_nav_tpu_torch.ops import conv2d as tconv

from torch_parity import tf32x3_conv

K8_TOL = 1e-4       # of max |out|, f32 (chip_smoke.py, test_torch_kernels)
SHAPES = [(2, 8, 10, 20, 36, 4, "silu"),
          (1, 8, 8, 160, 48, 4, "silu"),        # YOLOv8x's width 160
          (1, 4, 6, 3, 70, 2, "none"),
          (1, 4, 4, 640, 24, 2, "silu")]        # 9 * 640 products a sum


def _case(B, H, W, C, CO, th, act):
    rng = np.random.default_rng(C + CO)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(9, C, CO)) / np.sqrt(9 * C)).astype(np.float32)
    bias = rng.normal(size=(CO,)).astype(np.float32)
    want = np.asarray(jconv.conv3x3_s1(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), act=act, th=th,
        interpret=True))
    return x, w, bias, want


def _err(got, want):
    """max |got - want| over the bound, K8_TOL * max |out|."""
    return np.abs(np.asarray(got) - want).max() / (
        K8_TOL * np.abs(want).max())


@pytest.mark.parametrize("B,H,W,C,CO,th,act", SHAPES)
def test_tf32x3_order_holds_the_f32_bound(B, H, W, C, CO, th, act):
    """The kernel's order within K8_TOL of the Pallas kernel and of the
    port's plain version."""
    x, w, bias, want = _case(B, H, W, C, CO, th, act)
    got = tf32x3_conv(x, w, bias, act).numpy()
    assert _err(got, want) <= 1.0
    plain = tconv.conv3x3_s1_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        act).numpy()
    assert _err(got, plain) <= 1.0


@pytest.mark.parametrize("fault", ["lost_tap", "one_pass"])
@pytest.mark.parametrize("B,H,W,C,CO,th,act", SHAPES)
def test_tf32x3_bound_catches_a_fault(B, H, W, C, CO, th, act, fault):
    """A lost tap breaks K8_TOL by three orders of magnitude; one TF32
    product per product (a_hi b_hi alone) by 2-2.7x at these shapes,
    where the three passes stay below 0.005 of it."""
    x, w, bias, want = _case(B, H, W, C, CO, th, act)
    kw = {"drop_tap": 4} if fault == "lost_tap" else {"passes": 1}
    got = tf32x3_conv(x, w, bias, act, **kw).numpy()
    assert _err(got, want) > 1.0
