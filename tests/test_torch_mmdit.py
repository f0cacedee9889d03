"""The port's MMDiT (``models/mmdit.py``) against the JAX package's: forward
with a dual-attention block and a trimmed ``context_pre_only`` last block,
int8 W8A8, and the CFG Euler sampler with the JAX package's noise injected.

The zero-initialised adaLN ``mod``, ``final_mod`` and ``final_out``
linears are filled with seeded values first (``fill_zero_mods``):
otherwise attention never reaches the output.  At head_dim 64 and even
heads the port routes the joint attention to K4 (x rows first) while the
JAX package on the CPU takes its composed path (ctx rows first), so the
forward checks hold the two orders against each other.  Without qk-norm
(SD3-medium) and past 4096 joint tokens (SD3.5-medium at 1024^2) both
packages take the composed path, where the port's ``attention`` routes to
K5 or K6 by shape (their plain versions on the CPU).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.models import mmdit as JM
from bsc_nav_tpu_torch.models import mmdit as TM
from bsc_nav_tpu.models.weights import save_params_npz
from bsc_nav_tpu_torch.models.weights import (load_sd35_medium_npz,
                                              mmdit_from_jax_params)
from bsc_nav_tpu_torch.ops import flash_attention as tfa

from torch_parity import fill_zero_mods, numpy_tree

# head_dim 64 and 2 heads: the port takes K4's route
MMDIT_HD64 = JM.MMDiTConfig(input_size=8, patch_size=2, in_channels=4,
                            dim=128, depth=2, heads=2, context_dim=32,
                            pooled_dim=16, dual_attention_layers=(0,))
# SD3-medium's shape cut to size: no qk-norm, no dual attention, and the
# 512^2 latent grid, so the joint sequence (1024 + 5) passes 640 keys: K5
MMDIT_NO_QKNORM = JM.MMDiTConfig(input_size=64, patch_size=2, in_channels=4,
                                 dim=128, depth=2, heads=2, context_dim=32,
                                 pooled_dim=16, qk_norm=False)
# SD3.5-medium's 1024^2 latent grid: 4096 + 5 joint tokens, past K5 and K4
MMDIT_LONG = JM.MMDiTConfig(input_size=128, patch_size=2, in_channels=4,
                            dim=32, depth=1, heads=2, context_dim=32,
                            pooled_dim=16)


def _port_cfg(jcfg):
    return TM.MMDiTConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, pre_only=False, seed=0):
    p = fill_zero_mods(JM.init_params(jcfg, jax.random.PRNGKey(seed)),
                       seed + 1)
    if pre_only:
        # the last converted SD3 block: a 2-chunk (shift, scale) ctx norm
        last = p["blocks"][-1]["ctx"]
        last["mod"] = {"w": last["mod"]["w"][:, :2 * jcfg.dim],
                       "b": last["mod"]["b"][:2 * jcfg.dim]}
    return p


def _inputs(jcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(B, jcfg.input_size, jcfg.input_size,
                           jcfg.in_channels)).astype(np.float32)
    t = rng.uniform(0.05, 1.0, size=B).astype(np.float32)
    ctx = rng.normal(size=(B, S, jcfg.context_dim)).astype(np.float32)
    pooled = rng.normal(size=(B, jcfg.pooled_dim)).astype(np.float32)
    return lat, t, ctx, pooled


def test_configs_match_jax():
    for name in ("SD35_MEDIUM", "MMDIT_TEST", "MMDIT_TEST_DUAL"):
        assert (dataclasses.asdict(getattr(TM, name))
                == dataclasses.asdict(getattr(JM, name))), name
    assert TM.QUANT_KEYS == JM.QUANT_KEYS
    assert TM.SD35_MEDIUM.head_dim == 64


@pytest.mark.parametrize("case", ["composed-dual", "k4-dual",
                                  "k4-dual-pre-only", "k4-int8"])
def test_forward_matches_jax(case):
    """f32: 2e-4 abs on velocities of magnitude ~3 (the same ops, sums in
    another order through 2 blocks).  int8: both sides quantize equal
    weights to equal codes; an activation a few 1e-7 from a rounding
    boundary may take the neighbouring code on one side, so 2e-3 abs."""
    jcfg = JM.MMDIT_TEST_DUAL if case == "composed-dual" else MMDIT_HD64
    jp = _params(jcfg, pre_only=case.endswith("pre-only"))
    if case == "k4-int8":
        jp = JM.quantize_params(jp)
    tp = mmdit_from_jax_params(numpy_tree(jp), _port_cfg(jcfg), device="cpu")
    lat, t, ctx, pooled = _inputs(jcfg, 2, 5, seed=1)
    want = np.asarray(JM.forward(jp, *map(jnp.asarray, (lat, t, ctx, pooled)),
                                 jcfg))
    got = TM.forward(tp, *map(torch.from_numpy, (lat, t, ctx, pooled)),
                     _port_cfg(jcfg)).numpy()
    assert got.shape == lat.shape
    assert np.abs(want).max() > 0.5          # attention reached the output
    np.testing.assert_allclose(got, want,
                               atol=2e-3 if case == "k4-int8" else 2e-4,
                               rtol=0)


def test_route_is_k4_at_head_dim_64(monkeypatch):
    """At head_dim 64 every joint block calls joint_qkv_attention, and the
    dual block's self-attention reaches it through self_qkv_dispatch:
    depth + dual blocks calls per forward."""
    cfg = _port_cfg(MMDIT_HD64)
    tp = mmdit_from_jax_params(numpy_tree(_params(MMDIT_HD64)), cfg,
                               device="cpu")
    calls = []
    real = tfa.joint_qkv_attention

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(TM, "joint_qkv_attention", counted)
    monkeypatch.setattr(tfa, "joint_qkv_attention", counted)
    lat, t, ctx, pooled = _inputs(MMDIT_HD64, 1, 3, seed=2)
    TM.forward(tp, *map(torch.from_numpy, (lat, t, ctx, pooled)), cfg)
    assert len(calls) == cfg.depth + len(cfg.dual_attention_layers)


def test_sample_matches_jax_with_injected_noise():
    """CFG Euler sampling, 3 steps at scale 4: the JAX package's draw from
    its key is handed to the port.  f32 latents within 5e-4 abs (errors of
    2e-4 per velocity, times the guidance and the step sizes)."""
    jcfg = MMDIT_HD64
    jp = _params(jcfg, pre_only=True, seed=3)
    tp = mmdit_from_jax_params(numpy_tree(jp), _port_cfg(jcfg), device="cpu")
    _, _, ctx, pooled = _inputs(jcfg, 2, 5, seed=4)
    _, _, ctx_u, pooled_u = _inputs(jcfg, 2, 5, seed=5)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JM.sample(
        jp, key, jnp.asarray(ctx), jnp.asarray(pooled), jcfg, num_steps=3,
        guidance_scale=4.0, context_uncond=jnp.asarray(ctx_u),
        pooled_uncond=jnp.asarray(pooled_u)))
    noise = np.array(jax.random.normal(
        key, (2, jcfg.input_size, jcfg.input_size, jcfg.in_channels),
        jnp.float32))
    got = TM.sample(tp, torch.from_numpy(ctx), torch.from_numpy(pooled),
                    _port_cfg(jcfg), num_steps=3, guidance_scale=4.0,
                    context_uncond=torch.from_numpy(ctx_u),
                    pooled_uncond=torch.from_numpy(pooled_u),
                    noise=torch.from_numpy(noise)).numpy()
    assert np.abs(want - noise * float(JM.shifted_sigmas(3)[0])).max() > 0.1
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_schedule_and_timestep_embedding_match_jax():
    """torch.linspace and jnp.linspace round their steps differently: the
    sigmas agree within two f32 ulps of 1 (3e-7).  The embedding's
    arguments reach 1000 rad, where one f32 ulp of the argument (6e-5)
    moves a sine by as much: 1e-4 abs."""
    np.testing.assert_allclose(TM.shifted_sigmas(28).numpy(),
                               np.asarray(JM.shifted_sigmas(28)),
                               atol=3e-7, rtol=0)
    t = np.linspace(0.03, 1.0, 7).astype(np.float32)
    np.testing.assert_allclose(
        TM.timestep_embedding(torch.from_numpy(t)).numpy(),
        np.asarray(JM.timestep_embedding(jnp.asarray(t))), atol=1e-4,
        rtol=0)


def _counted(monkeypatch, name):
    """Count the calls of ``tfa.<name>`` (the MMDiT reaches it through
    ``attention``)."""
    calls = []
    real = getattr(tfa, name)

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tfa, name, counted)
    return calls


@pytest.mark.parametrize("jcfg,route", [
    (MMDIT_NO_QKNORM, "mid_attention"),
    (MMDIT_LONG, "reference_attention"),
    (MMDIT_LONG, "flash_attention")])
def test_composed_forward_matches_jax(monkeypatch, jcfg, route):
    """The composed joint attention (ctx rows first) without qk-norm at
    1029 tokens (K5's route) and with qk-norm at 4101 tokens: there the
    logits of B 2 x 2 heads are 0.27 GB, under K6's 4e9, so the port takes
    the plain composition as the JAX package does; with that threshold at 0
    the same forward goes through K6's route.  f32: 2e-4 abs, as above."""
    if route == "flash_attention":
        monkeypatch.setattr(tfa, "_FLASH_MIN_LOGITS_BYTES", 0)
    calls = _counted(monkeypatch, route)
    jp = _params(jcfg, seed=4)
    tp = mmdit_from_jax_params(numpy_tree(jp), _port_cfg(jcfg), device="cpu")
    lat, t, ctx, pooled = _inputs(jcfg, 2, 5, seed=6)
    want = np.asarray(JM.forward(jp, *map(jnp.asarray, (lat, t, ctx, pooled)),
                                 jcfg))
    got = TM.forward(tp, *map(torch.from_numpy, (lat, t, ctx, pooled)),
                     _port_cfg(jcfg)).numpy()
    assert len(calls) == jcfg.depth
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_sample_without_qk_norm_matches_jax():
    """SD3-medium's route (K5) through 3 CFG steps at scale 4, the JAX
    package's noise injected: 5e-4 abs, as above."""
    jcfg = MMDIT_NO_QKNORM
    jp = _params(jcfg, seed=7)
    tp = mmdit_from_jax_params(numpy_tree(jp), _port_cfg(jcfg), device="cpu")
    _, _, ctx, pooled = _inputs(jcfg, 1, 5, seed=8)
    _, _, ctx_u, pooled_u = _inputs(jcfg, 1, 5, seed=9)
    key = jax.random.PRNGKey(10)
    want = np.asarray(JM.sample(
        jp, key, jnp.asarray(ctx), jnp.asarray(pooled), jcfg, num_steps=3,
        guidance_scale=4.0, context_uncond=jnp.asarray(ctx_u),
        pooled_uncond=jnp.asarray(pooled_u)))
    noise = np.array(jax.random.normal(
        key, (1, jcfg.input_size, jcfg.input_size, jcfg.in_channels),
        jnp.float32))
    got = TM.sample(tp, torch.from_numpy(ctx), torch.from_numpy(pooled),
                    _port_cfg(jcfg), num_steps=3, guidance_scale=4.0,
                    context_uncond=torch.from_numpy(ctx_u),
                    pooled_uncond=torch.from_numpy(pooled_u),
                    noise=torch.from_numpy(noise)).numpy()
    assert np.abs(want - noise * float(JM.shifted_sigmas(3)[0])).max() > 0.1
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_weights_without_qk_norm_carry_over(tmp_path):
    """A qk_norm=False tree (no q_norm / k_norm leaves) loads from the JAX
    tree and from its .npz, leaf for leaf; a config that disagrees with
    the tree about qk-norm raises."""
    jcfg = dataclasses.replace(MMDIT_NO_QKNORM, input_size=8)
    jp = _params(jcfg, seed=11)
    assert "q_norm" not in jp["blocks"][0]["x"]
    tcfg = _port_cfg(jcfg)
    path = str(tmp_path / "sd3_medium.npz")
    save_params_npz(jp, path)
    for tp in (mmdit_from_jax_params(numpy_tree(jp), tcfg, device="cpu"),
               load_sd35_medium_npz(path, tcfg, device="cpu")):
        assert set(tp["blocks"][1]["ctx"]) == set(jp["blocks"][1]["ctx"])
        np.testing.assert_array_equal(
            tp["blocks"][1]["x"]["qkv"]["w"].numpy(),
            np.asarray(jp["blocks"][1]["x"]["qkv"]["w"]))
    with pytest.raises(ValueError, match="qk_norm=True"):
        mmdit_from_jax_params(numpy_tree(jp),
                              dataclasses.replace(tcfg, qk_norm=True),
                              device="cpu")
    with pytest.raises(ValueError, match="qk_norm=False"):
        mmdit_from_jax_params(numpy_tree(_params(MMDIT_HD64)),
                              dataclasses.replace(_port_cfg(MMDIT_HD64),
                                                  qk_norm=False),
                              device="cpu")


@pytest.fixture(scope="module")
def pre_only_params():
    """MMDIT_HD64 (K4's route, a dual block) with a 2-chunk last block."""
    return _params(MMDIT_HD64, pre_only=True, seed=12)


@pytest.mark.parametrize("case", ["k4-dual", "k4-int8"])
def test_fuse_mods_matches_jax_and_the_per_block_path(case, pre_only_params):
    """``fuse_mods`` applied on each side to the carried per-block tree (a
    2-chunk ``context_pre_only`` last block; int8: after
    ``quantize_params``): the same layout as JAX's, no "mod" or
    "final_mod" left; the fused forward against JAX's fused forward at the
    forward tolerances above (f32 2e-4, int8 2e-3), and against the port's
    per-block forward on the same tree: f32 within 2e-5 (each modulation
    column is the same D-long sum, in another GEMM's order;
    tests/test_mmdit.py's bound), int8 within 2e-3 (a modulation an ulp
    apart can move an activation across a rounding boundary).  f32: the
    fused CFG sampler against JAX's fused sampler with its noise injected
    (5e-4, as above) and against the port's per-block sampler (2e-5)."""
    jcfg = MMDIT_HD64
    cfg = _port_cfg(jcfg)
    jp = pre_only_params
    if case == "k4-int8":
        jp = JM.quantize_params(jp)
    tp = mmdit_from_jax_params(numpy_tree(jp), cfg, device="cpu")
    jf, jlayout = JM.fuse_mods(jp, jcfg)
    tf, layout = TM.fuse_mods(tp, cfg)
    assert layout == jlayout and layout[-1][1] == 2
    assert layout[0] == (9 if 0 in cfg.dual_attention_layers else 6, 6)
    assert "final_mod" not in tf and all(
        "mod" not in blk[s] for blk in tf["blocks"] for s in ("x", "ctx"))
    assert tf["mods"]["w"].shape == (cfg.dim, sum(map(sum, layout))
                                     * cfg.dim + 2 * cfg.dim)
    lat, t, ctx, pooled = _inputs(jcfg, 2, 5, seed=13)
    want = np.asarray(JM.forward(jf, *map(jnp.asarray, (lat, t, ctx, pooled)),
                                 jcfg, mod_layout=jlayout))
    args = [torch.from_numpy(a) for a in (lat, t, ctx, pooled)]
    got = TM.forward(tf, *args, cfg, mod_layout=layout).numpy()
    per_block = TM.forward(tp, *args, cfg).numpy()
    assert np.abs(want).max() > 0.5
    int8 = case == "k4-int8"
    np.testing.assert_allclose(got, want, atol=2e-3 if int8 else 2e-4,
                               rtol=0)
    np.testing.assert_allclose(got, per_block, atol=2e-3 if int8 else 2e-5,
                               rtol=0 if int8 else 2e-5)
    if int8:
        # quantize_params and fuse_mods compose in either order
        q = TM.fuse_mods(TM.quantize_params(mmdit_from_jax_params(
            numpy_tree(pre_only_params), cfg, device="cpu")), cfg)[0]
        np.testing.assert_array_equal(
            TM.forward(q, *args, cfg, mod_layout=layout).numpy(), got)
        return
    _, _, ctx_u, pooled_u = _inputs(jcfg, 1, 5, seed=14)
    key = jax.random.PRNGKey(15)
    jsamp = np.asarray(JM.sample(
        jf, key, jnp.asarray(ctx[:1]), jnp.asarray(pooled[:1]), jcfg,
        num_steps=2, guidance_scale=2.0, context_uncond=jnp.asarray(ctx_u),
        pooled_uncond=jnp.asarray(pooled_u), mod_layout=jlayout))
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (1, jcfg.input_size, jcfg.input_size, jcfg.in_channels),
        jnp.float32)))
    kw = dict(num_steps=2, guidance_scale=2.0,
              context_uncond=torch.from_numpy(ctx_u),
              pooled_uncond=torch.from_numpy(pooled_u), noise=noise)
    samp = TM.sample(tf, args[2][:1], args[3][:1], cfg, mod_layout=layout,
                     **kw).numpy()
    np.testing.assert_allclose(samp, jsamp, atol=5e-4, rtol=0)
    np.testing.assert_allclose(
        samp, TM.sample(tp, args[2][:1], args[3][:1], cfg, **kw).numpy(),
        atol=2e-5, rtol=2e-5)
