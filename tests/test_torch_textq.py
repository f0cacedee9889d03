"""The text query end to end against the JAX package: ``DiffusionImagination``
(CLIP-L/G + T5 conditioning -> MMDiT CFG sampler -> VAE) and the text
query step (imagination -> DINOv2 encode -> store scan -> top-K), then the
agent's ``voxel_localized(str)``.

Tiny configs, f32.  The MMDiT has head_dim 64 and even heads, so the port
takes K4's route (x rows first) while the JAX package on the CPU takes its
composed path (ctx rows first); it has a dual-attention block and a
``context_pre_only`` last block, and its zero-initialised modulation is
filled with seeded values.  The JAX package's noise, drawn from its key,
is injected into the port.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.agents import spatial_memory as jsm
from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.memory import pipeline as jpipe
from bsc_nav_tpu.memory.store import init_store as jinit
from bsc_nav_tpu.models import clip as JC
from bsc_nav_tpu.models import mmdit as JM
from bsc_nav_tpu.models import sentencepiece as JSP
from bsc_nav_tpu.models import t5 as JT5
from bsc_nav_tpu.models import tokenizer as JTok
from bsc_nav_tpu.models import vae as JV
from bsc_nav_tpu.models import vit as jv
from bsc_nav_tpu.models.imagination import DiffusionImagination as JImagination
from bsc_nav_tpu_torch.agents import spatial_memory as tsm
from bsc_nav_tpu_torch.config import small_test_config as t_small_config
from bsc_nav_tpu_torch.memory import pipeline as tpipe
from bsc_nav_tpu_torch.models import clip as TC
from bsc_nav_tpu_torch.models import mmdit as TM
from bsc_nav_tpu_torch.models import sentencepiece as TSP
from bsc_nav_tpu_torch.models import t5 as TT5
from bsc_nav_tpu_torch.models import tokenizer as TTok
from bsc_nav_tpu_torch.models import vae as TV
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models.imagination import DiffusionImagination
from bsc_nav_tpu_torch.models.weights import (
    clip_from_jax_params, mmdit_from_jax_params, t5_from_jax_params,
    vae_from_jax_params, vit_from_jax_params)

from torch_parity import (assert_same_topk, fill_zero_mods, numpy_tree,
                          store_from_jax)

PROMPT = "a sofa"
MCFG = JM.MMDiTConfig(input_size=8, patch_size=2, in_channels=4, dim=128,
                      depth=2, heads=2, context_dim=32, pooled_dim=16,
                      dual_attention_layers=(0,))
VCFG = dataclasses.replace(JV.VAE_TEST, latent_channels=4, blocks_per_stage=1)
VIT_KW = dict(img_size=28, patch_size=14, dim=32, depth=2, heads=2,
              num_registers=1)
T5_LEN = 8
TOY_PIECES = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0),
              ("▁", -3.0), ("▁a", -1.0), ("▁sofa", -1.5),
              ("s", -4.0), ("o", -4.0), ("f", -4.0), ("a", -4.0)]
KINDS = (3, 3, 2) + (1,) * 7            # control, control, unknown, normal
# T5 as T5_TEST but as wide as the MMDiT's joint context
T5CFG = dataclasses.replace(JT5.T5_TEST, dim=MCFG.context_dim, heads=2)


def _sp(module):
    return module.SentencePieceUnigram.from_model_bytes(
        module.serialize_model_proto(
            [(p, s, k) for (p, s), k in zip(TOY_PIECES, KINDS)]))


def _port(jcfg, cls):
    return cls(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def stack():
    """A JAX imagination and the port's over the same weights, and a
    store built by the JAX pipeline."""
    mp = fill_zero_mods(JM.init_params(MCFG, jax.random.PRNGKey(1)), 2)
    last = mp["blocks"][-1]["ctx"]      # context_pre_only last block
    last["mod"] = {"w": last["mod"]["w"][:, :2 * MCFG.dim],
                   "b": last["mod"]["b"][:2 * MCFG.dim]}
    vp = JV.init_params(VCFG, jax.random.PRNGKey(3))
    lcfg, gcfg = JC.SD3_CLIP_L_TEST, JC.SD3_CLIP_G_TEST
    lp = JC.init_params(lcfg, jax.random.PRNGKey(4))
    gp = JC.init_params(gcfg, jax.random.PRNGKey(5))
    t5p = JT5.init_params(T5CFG, jax.random.PRNGKey(6))
    tok_kw = dict(vocab_size=lcfg.vocab_size,
                  context_length=lcfg.context_length)
    common = dict(num_images=2, num_steps=2, seed=9, t5_seq_len=T5_LEN)
    jim = JImagination(
        mmdit_params=mp, mmdit_cfg=MCFG, vae_params=vp, vae_cfg=VCFG,
        clip_l_params=lp["text"], clip_l_cfg=lcfg,
        clip_g_params=gp["text"], clip_g_cfg=gcfg,
        tokenizer=JTok.HashTokenizer(**tok_kw), t5_params=t5p,
        t5_cfg=T5CFG, t5_tokenizer=_sp(JSP), **common)
    tlcfg, tgcfg = _port(lcfg, TC.CLIPConfig), _port(gcfg, TC.CLIPConfig)
    tim = DiffusionImagination(
        mmdit_params=mmdit_from_jax_params(
            numpy_tree(mp), _port(MCFG, TM.MMDiTConfig), device="cpu"),
        mmdit_cfg=_port(MCFG, TM.MMDiTConfig),
        vae_params=vae_from_jax_params(numpy_tree(vp),
                                       _port(VCFG, TV.VAEConfig),
                                       device="cpu"),
        vae_cfg=_port(VCFG, TV.VAEConfig),
        clip_l_params=clip_from_jax_params(numpy_tree(lp), tlcfg,
                                           device="cpu").text,
        clip_l_cfg=tlcfg,
        clip_g_params=clip_from_jax_params(numpy_tree(gp), tgcfg,
                                           device="cpu").text,
        clip_g_cfg=tgcfg,
        tokenizer=TTok.HashTokenizer(**tok_kw),
        t5_params=t5_from_jax_params(numpy_tree(t5p),
                                     _port(T5CFG, TT5.T5Config),
                                     device="cpu"),
        t5_cfg=_port(T5CFG, TT5.T5Config), t5_tokenizer=_sp(TSP), **common)

    cfg = small_test_config()
    vit_cfg = jv.ViTConfig(**VIT_KW)
    vit_params = jv.init_params(vit_cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    B, H, W = 6, cfg.sensor.height, cfg.sensor.width
    rgb = rng.integers(0, 255, (B, H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0.5, 3.0, (B, H, W)).astype(np.float32)
    yaws = np.linspace(0, 2 * np.pi, B, endpoint=False)
    poses = np.zeros((B, 7), np.float32)
    poses[:, 4], poses[:, 6] = np.sin(yaws / 2), np.cos(yaws / 2)
    (jstate, _), _ = jpipe.make_build_step(cfg, vit_cfg)(
        (jinit(cfg.memory), jax.random.PRNGKey(5)), vit_params,
        *map(jnp.asarray, (rgb, depth, poses)))
    assert int(jstate.num_voxels) > 50
    tvit = vit_from_jax_params(numpy_tree(vit_params), tv.ViTConfig(**VIT_KW),
                               device="cpu")
    return jim, tim, cfg, vit_cfg, vit_params, jstate, tvit


def _noise(key):
    return torch.from_numpy(np.array(jax.random.normal(
        key, (2, MCFG.input_size, MCFG.input_size, MCFG.in_channels),
        jnp.float32)))


def test_prep_inputs_match_jax(stack):
    """CLIP ids (L padded with <|endoftext|>, G with 0) and T5 ids with
    </s> kept last are equal."""
    jim, tim = stack[:2]
    for a, b in zip(jim.prep_inputs(PROMPT), tim.prep_inputs(PROMPT)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    t5_ids = tim.prep_inputs(PROMPT)[2].numpy()[0]
    assert t5_ids.shape == (T5_LEN,) and 1 in t5_ids and t5_ids[-1] == 0


def test_imagination_matches_jax(stack):
    """Conditioning within 1e-4 (f32 towers); the images from the same
    noise differ by at most 1 uint8 level (a float within 1e-4 of a
    rounding boundary may truncate either way)."""
    jim, tim = stack[:2]
    ji, ti = jim.prep_inputs(PROMPT), tim.prep_inputs(PROMPT)
    text = {"l": jim.clip_l_params, "g": jim.clip_g_params}
    jctx, jpool = jim.encode_conditioning(text, jim.t5_params, ji[0], ji[2])
    tctx, tpool = tim.encode_conditioning(ti[0], ti[2])
    assert tctx.shape == (1, 16 + T5_LEN, MCFG.context_dim)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=1e-4)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-4)

    key = jax.random.PRNGKey(11)
    want = np.asarray(jim.imagine_core(
        jim.mmdit_params, jim.vae_params, text, jim.t5_params, *ji, key))
    got = tim.imagine_core(*ti, noise=_noise(key)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 16, 16, 3)
    assert np.ptp(want) > 50                  # not a flat image
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("split", [False, True])
def test_text_query_step_matches_jax(stack, split):
    """The port's single and split text-query steps against JAX
    ``make_text_query_step`` on one store and one noise: top-K scores
    within 1e-4, equal voxel sets above the K-th score."""
    jim, tim, cfg, vit_cfg, vit_params, jstate, tvit = stack
    key = jax.random.PRNGKey(13)
    jpos, jsc, _ = jpipe.make_text_query_step(cfg, vit_cfg, jim)(
        jstate, vit_params, jim.mmdit_params, jim.vae_params,
        jim.text_params, jim.t5_params, *jim.prep_inputs(PROMPT), key,
        top_k=16)
    tcfg = t_small_config()
    state = store_from_jax(jstate)
    inputs = tim.prep_inputs(PROMPT)
    if split:
        pooled, _ = tpipe.make_text_pool_step(tcfg, tvit.cfg, tim)(
            tvit, *inputs, noise=_noise(key))
        from bsc_nav_tpu_torch.memory.query import localize
        tpos, tsc = localize(state, pooled, top_k=16)
    else:
        tpos, tsc, imgs = tpipe.make_text_query_step(tcfg, tvit.cfg, tim)(
            state, tvit, *inputs, noise=_noise(key), top_k=16)
        assert imgs.shape == (2, 16, 16, 3)
    assert np.isfinite(np.asarray(jsc)).all()
    assert_same_topk(np.asarray(jpos), np.asarray(jsc), tpos.numpy(),
                     tsc.numpy(), atol=1e-4)


def test_agent_voxel_localized_text_matches_jax(stack):
    """``VoxelTokenMemory.voxel_localized("a sofa")`` on the same store:
    the JAX agent draws its noise from its imagination's key stream, which
    the port's imagination is handed in place of its own generator."""
    jim, tim, cfg, vit_cfg, vit_params, jstate, tvit = stack
    jmem = jsm.VoxelTokenMemory(
        cfg, None, jsm.Perception.create(cfg, vit_cfg, vit_params=vit_params),
        imagination=jim)
    jmem.state = jstate
    _, sub = jax.random.split(jim._key)          # the draw next_key makes
    jbest, jpos, jsc = jmem.voxel_localized(PROMPT, K=16)

    tcfg = t_small_config()
    tmem = tsm.VoxelTokenMemory(
        tcfg, None, tsm.Perception.create(tcfg, tvit.cfg, vit_params=tvit,
                                          device="cpu"),
        imagination=tim)
    tmem.state = store_from_jax(jstate)
    tim.next_noise = lambda: _noise(sub)
    try:
        tbest, tpos, tsc = tmem.voxel_localized(PROMPT, K=16)
    finally:
        del tim.next_noise
    assert tmem.last_imagined.shape == (2, 16, 16, 3)
    assert len(tpos) == len(jpos) == 16
    assert_same_topk(jpos, jsc, tpos, tsc, atol=1e-4)
    assert tmem.imaginary(PROMPT).shape == (2, 16, 16, 3)
