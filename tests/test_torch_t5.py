"""The port's T5 encoder against the JAX package's (``models/t5.py``), f32
and int8, on the same weights and ids."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.models import t5 as JT5
from bsc_nav_tpu_torch.models import t5 as TT5
from bsc_nav_tpu_torch.models.weights import t5_from_jax_params

from torch_parity import bf16_ulp, numpy_tree


def _ids(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    ids[:, -3:] = 0                      # padding, as T5 prompts end
    return ids


def test_relative_buckets_match_jax():
    """The bucket of every offset up to the T5-XXL window (512) is equal:
    a bucket off by one at a log boundary would move the position bias."""
    rel = np.arange(-600, 601, dtype=np.int32)
    want = np.asarray(JT5._relative_buckets(jnp.asarray(rel), 32, 128))
    got = TT5._relative_buckets(torch.from_numpy(rel), 32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_params_host_matches_jax():
    """Host quantization of one tree: equal int8 codes and scales."""
    params = numpy_tree(JT5.init_params(JT5.T5_TEST, jax.random.PRNGKey(1)))
    want = JT5.quantize_params_host(params)
    got = TT5.quantize_params_host(params)
    flat = jax.tree_util.tree_flatten_with_path
    (wl, wt), (gl, gt) = flat(want), flat(got)
    assert wt == gt
    for (path, a), (_, b) in zip(wl, gl):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("mode", ["f32", "f32-masked", "int8-device",
                                  "int8-host"])
def test_encode_matches_jax(mode):
    """f32: the same ops in f32, sums in another order: 1e-4 abs on O(1)
    features.  int8: the table dequantizes to bf16 and both encoders run
    the same bf16 ops over equal int8 codes (equal here); an activation
    code flipped at a rounding boundary would move a feature by a bf16
    ulp or two: two bf16 ulps at the feature's magnitude."""
    cfg = JT5.T5_TEST
    jparams = JT5.init_params(cfg, jax.random.PRNGKey(0))
    ids = _ids(cfg, 2, 12, seed=3)
    mask = None
    if mode == "int8-device":
        jparams = JT5.quantize_params(jparams)
        tparams = t5_from_jax_params(numpy_tree(jparams), TT5.T5_TEST,
                                     device="cpu")
    elif mode == "int8-host":
        host = JT5.quantize_params_host(numpy_tree(jparams))
        jparams = jax.tree.map(jnp.asarray, host)
        tparams = t5_from_jax_params(TT5.quantize_params_host(
            numpy_tree(JT5.init_params(cfg, jax.random.PRNGKey(0)))),
            TT5.T5_TEST, device="cpu")
    else:
        tparams = t5_from_jax_params(numpy_tree(jparams), TT5.T5_TEST,
                                     device="cpu")
        if mode == "f32-masked":
            mask = ids > 0
    want = np.asarray(JT5.encode(
        jparams, jnp.asarray(ids), cfg,
        mask=None if mask is None else jnp.asarray(mask)).astype(
            jnp.float32))
    got = TT5.encode(tparams, torch.from_numpy(ids), TT5.T5_TEST,
                     mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 12, cfg.dim)
    got = got.float().numpy()
    if mode.startswith("int8"):
        assert np.isfinite(got).all()
        ulp = bf16_ulp(torch.from_numpy(np.array(want))).numpy()
        assert np.all(np.abs(got - want) <= 2 * ulp)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_config_matches_jax():
    assert TT5.T5_XXL.__dict__ == JT5.T5_XXL.__dict__
    assert TT5.T5_TEST.__dict__ == JT5.T5_TEST.__dict__
    assert TT5.QUANT_KEYS == JT5.QUANT_KEYS
