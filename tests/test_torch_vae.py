"""The port's VAE decoder (``models/vae.py``) against the JAX package's."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.models import vae as JV
from bsc_nav_tpu_torch.models import vae as TV
from bsc_nav_tpu_torch.models.weights import vae_from_jax_params

from torch_parity import numpy_tree


def test_configs_match_jax():
    for name in ("SD3_VAE", "VAE_TEST"):
        assert (dataclasses.asdict(getattr(TV, name))
                == dataclasses.asdict(getattr(JV, name))), name


@pytest.mark.parametrize("cfg_name", ["VAE_TEST", "three-stage"])
def test_decode_matches_jax(cfg_name):
    """f32 convolutions (cuDNN / oneDNN against XLA), sums in another
    order through ~20 layers: 1e-4 abs on outputs of magnitude ~1."""
    jcfg = (JV.VAE_TEST if cfg_name == "VAE_TEST" else dataclasses.replace(
        JV.VAE_TEST, channel_mults=(1, 2, 2), blocks_per_stage=1,
        scaling_factor=1.5305, shift_factor=0.0609))
    tcfg = TV.VAEConfig(**dataclasses.asdict(jcfg))
    jp = JV.init_params(jcfg, jax.random.PRNGKey(0))
    tp = vae_from_jax_params(numpy_tree(jp), tcfg, device="cpu")
    lat = np.random.default_rng(1).normal(
        size=(2, 6, 6, jcfg.latent_channels)).astype(np.float32)
    want = np.asarray(JV.decode(jp, jnp.asarray(lat), jcfg))
    got = TV.decode(tp, torch.from_numpy(lat), tcfg).numpy()
    scale = 2 ** (len(jcfg.channel_mults) - 1)
    assert got.shape == (2, 6 * scale, 6 * scale, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        TV.to_uint8(torch.from_numpy(np.clip(want, -1.2, 1.2))).numpy(),
        np.asarray(JV.to_uint8(jnp.clip(jnp.asarray(want), -1.2, 1.2))))


def test_group_norm_low_variance_large_mean():
    """The case of tests/test_mmdit.py: mean 100, std 0.01.  The centered
    two-pass variance stays finite and matches a float64 oracle within
    5e-3, the JAX test's bound, as the JAX package's result does.  At mean
    100 an f32 ulp is 7.6e-6, 1.1e-3 of a normalised value at this std
    and scale, so the two f32 sides (sums in another order) are held to
    each other within the same 5e-3."""
    rng = np.random.default_rng(0)
    x = (100.0 + 0.01 * rng.standard_normal((1, 16, 16, 32))).astype(
        np.float32)
    g = 4
    jp = {"scale": jnp.full((32,), 1.5, jnp.float32),
          "bias": jnp.full((32,), 0.25, jnp.float32)}
    tp = {"scale": torch.full((32,), 1.5), "bias": torch.full((32,), 0.25)}
    got = TV._group_norm(torch.from_numpy(x), tp, g).numpy()
    assert np.isfinite(got).all()
    x64 = x.astype(np.float64).reshape(1, 16, 16, g, 8)
    mu = x64.mean(axis=(1, 2, 4), keepdims=True)
    var = x64.var(axis=(1, 2, 4), keepdims=True)
    ref = ((x64 - mu) / np.sqrt(var + 1e-6)).reshape(1, 16, 16, 32)
    np.testing.assert_allclose(got, ref * 1.5 + 0.25, rtol=5e-3, atol=5e-3)
    want = np.asarray(JV._group_norm(jnp.asarray(x), jp, g))
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
