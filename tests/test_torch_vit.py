"""Port parity: the DINOv2-family ViT against bsc_nav_tpu/models/vit.py,
and the weight loaders against bsc_nav_tpu/models/weights.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.models import vit as jv
from bsc_nav_tpu.models import weights as jw
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models import weights as tw


@pytest.mark.parametrize("src,dst,atol", [
    (64, 28, 2e-6),
    # 680 -> 224: JAX's own f32 resize is off a float64 evaluation of the
    # same matrices by ~1.1e-5 (x 1/std after normalization); the port's
    # by ~1e-7.  Hence 1e-4 abs here.
    (680, 224, 1e-4),
])
def test_preprocess_matches_jax(src, dst, atol):
    img = np.random.default_rng(0).integers(0, 255, size=(2, src, src, 3),
                                            dtype=np.uint8)
    want = np.asarray(jv.preprocess(jnp.asarray(img), out_hw=(dst, dst)))
    got = tv.preprocess(torch.from_numpy(img), out_hw=(dst, dst)).numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("src,dst", [(37, 16), (16, 20)])
def test_interpolate_pos_embed_matches_jax(src, dst):
    # bicubic Keys a=-0.5, antialiased when downsampling; 1e-5 abs
    pos = np.random.default_rng(1).normal(
        size=(1, 1 + src * src, 8)).astype(np.float32)
    want = np.asarray(jv.interpolate_pos_embed(jnp.asarray(pos), (dst, dst)))
    got = tv.interpolate_pos_embed(torch.from_numpy(pos), (dst, dst)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_params(cfg, seed=1):
    """JAX-initialized params with the layerscales, biases and LayerNorms
    randomized so that every parameter moves the output."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(np.asarray,
                               jv.init_params(cfg, jax.random.PRNGKey(seed)))

    def jitter(a):
        return (a + rng.normal(size=a.shape) * 0.1).astype(np.float32)

    p["norm"] = {k: jitter(v) for k, v in p["norm"].items()}
    for blk in p["blocks"]:
        for k in ("ln1", "ln2", "qkv", "proj", "fc1", "fc2"):
            blk[k] = {n: (jitter(v) if n != "w" else v)
                      for n, v in blk[k].items()}
        if "ls1" in blk:
            blk["ls1"], blk["ls2"] = jitter(blk["ls1"]), jitter(blk["ls2"])
    return p


@pytest.mark.parametrize("kw", [
    {},
    {"gelu_exact": True},
    {"ffn": "swiglu", "num_registers": 0, "layerscale": False},
])
def test_forward_features_matches_jax(kw):
    # 2 layers, f32 on both sides; 1e-5 abs on O(1) LayerNorm outputs
    kw = {"img_size": 28, "patch_size": 14, "dim": 64, "depth": 2,
          "heads": 4, "num_registers": 2, **kw}
    jcfg, tcfg = jv.ViTConfig(**kw), tv.ViTConfig(**kw)
    p = _jax_params(jcfg)
    x = np.random.default_rng(2).normal(size=(2, 28, 28, 3)).astype(
        np.float32)
    want = jv.forward_features(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x), jcfg)
    got = tw.vit_from_jax_params(p, tcfg).forward_features(
        torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_npz_written_by_jax_loads(tmp_path):
    jcfg = jv.ViTConfig(img_size=28, patch_size=14, dim=32, depth=1,
                        heads=2, num_registers=1)
    tcfg = tv.ViTConfig(img_size=28, patch_size=14, dim=32, depth=1,
                        heads=2, num_registers=1)
    p = jv.init_params(jcfg, jax.random.PRNGKey(3))
    path = str(tmp_path / "vit.npz")
    jw.save_params_npz(p, path)
    model = tw.load_dinov2_npz(path, tcfg)
    flat = jw.flatten_params(p)
    sd = model.state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_init_params_layout_and_scale():
    cfg = tv.ViTConfig(img_size=28, patch_size=14, dim=64, depth=2, heads=4)
    gen = torch.Generator().manual_seed(0)
    model = tv.init_params(cfg, gen)
    jp = jw.flatten_params(jv.init_params(
        jv.ViTConfig(img_size=28, patch_size=14, dim=64, depth=2, heads=4),
        jax.random.PRNGKey(0)))
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: v.shape for k, v in jp.items()}
    assert torch.all(sd["blocks.0.ls1"] == 1e-5)
    assert torch.all(sd["blocks.1.ln2.scale"] == 1)
    w = sd["blocks.0.fc1.w"]
    assert abs(w.std().item() * 8.0 - 1.0) < 0.05      # N(0, 1/fan_in)
