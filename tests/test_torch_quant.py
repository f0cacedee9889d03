"""Port parity: int8 W8A8 linear (quantize_weight, linear_q8, linear)
against bsc_nav_tpu/ops/quant.py, and the quantized ``Linear`` module."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import quant as jq
from bsc_nav_tpu_torch.models.vit import Linear
from bsc_nav_tpu_torch.ops import quant as tq


def _wxb(fi, fo, rows, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(fi, fo)) / np.sqrt(fi)).astype(np.float32)
    b = rng.normal(size=fo).astype(np.float32)
    x = rng.normal(size=(2, rows, fi)).astype(np.float32)
    x[0, 0] = 0.0                       # an all-zero row: scale 1e-12 / 127
    return w, x, b


@pytest.mark.parametrize("fi,fo", [(160, 480), (64, 256), (96, 8)])
def test_quantize_weight_codes_and_scales_equal(fi, fo):
    w, _, b = _wxb(fi, fo, 3, seed=fi)
    w[:, 0] = 0.0                       # a zero column: scale 1e-12 / 127
    want = jq.quantize_weight({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    got = tq.quantize_weight({"w": torch.from_numpy(w),
                              "b": torch.from_numpy(b)})
    assert got["w_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
    np.testing.assert_array_equal(got["w_s"].numpy(), np.asarray(want["w_s"]))
    np.testing.assert_array_equal(got["b"].numpy(), b)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("fi,fo,rows", [(160, 480, 17), (64, 256, 77)])
def test_linear_q8_matches_jax(fi, fo, rows, bias):
    """Equal int8 codes on both sides (true division for the activation
    scale on both) and an exact int32 product; the f32 epilogue rounds
    alike: 1e-6 abs on O(1) outputs."""
    w, x, b = _wxb(fi, fo, rows, seed=rows)
    jp = jq.quantize_weight({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tp = tq.quantize_weight({"w": torch.from_numpy(w),
                             "b": torch.from_numpy(b)})
    if not bias:
        jp.pop("b")
        tp.pop("b")
    want = np.asarray(jq.linear_q8(jnp.asarray(x), jp))
    got = tq.linear_q8(torch.from_numpy(x), tp)
    assert got.shape == (2, rows, fo) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the dispatching form takes the same route
    np.testing.assert_allclose(tq.linear(torch.from_numpy(x), tp).numpy(),
                               want, atol=1e-6, rtol=0)


def test_plain_linear_matches_jax():
    """f32 accumulation of f32 inputs: 1e-5 abs."""
    w, x, b = _wxb(64, 96, 5, seed=1)
    want = np.asarray(jq.linear(jnp.asarray(x), {"w": jnp.asarray(w),
                                                 "b": jnp.asarray(b)}))
    got = tq.linear(torch.from_numpy(x), {"w": torch.from_numpy(w),
                                          "b": torch.from_numpy(b)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_quantized_linear_module():
    """``Linear(quantized=True)`` holds the JAX leaves (``w_q``, ``w_s``,
    ``b``) and serves them through linear_q8."""
    w, x, b = _wxb(64, 96, 20, seed=2)
    jp = jq.quantize_weight({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    lin = Linear(64, 96, quantized=True)
    assert set(lin.state_dict()) == {"w_q", "w_s", "b"}
    lin.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in jp.items()})
    assert lin.w_q.dtype == torch.int8 and lin.w is None
    np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(),
                               np.asarray(jq.linear_q8(jnp.asarray(x), jp)),
                               atol=1e-6, rtol=0)
