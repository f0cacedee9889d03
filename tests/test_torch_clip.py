"""Port parity for the CLIP slice: the towers (bsc_nav_tpu/models/clip.py),
the matcher (agents/matchers.py) and the CLIP-patch detector
(models/detector.py), in f32 and int8, on the CPU.

JAX params are made once with ``clip.init_params`` and carried across with
``clip_from_jax_params``.  Two configs: CLIP_VITB32_TEST, and a tiny one
that keeps MetaCLIP ViT-H's vision head_dim 80 and a causal text tower at
head_dim 64 (the two shapes that route to kernel K3 on the card).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.agents.matchers import CLIPMatcher as JMatcher
from bsc_nav_tpu.config import HM3D_DETECT_CLASSES
from bsc_nav_tpu.models import clip as JC
from bsc_nav_tpu.models.detector import ClipPatchDetector as JDetector
from bsc_nav_tpu.models.tokenizer import HashTokenizer
from bsc_nav_tpu.models.weights import save_params_npz
from bsc_nav_tpu_torch.agents.matchers import CLIPMatcher
from bsc_nav_tpu_torch.models import clip as TC
from bsc_nav_tpu_torch.models.detector import ClipPatchDetector
from bsc_nav_tpu_torch.models.weights import (
    clip_from_jax_params, load_clip_npz)

HD80 = dict(embed_dim=32, image_size=56, patch_size=14, vision_width=160,
            vision_layers=2, vision_heads=2, context_length=16,
            vocab_size=512, text_width=128, text_heads=2, text_layers=2)
CONFIGS = {"vitb32_test": dataclasses.asdict(JC.CLIP_VITB32_TEST),
           "hd80": HD80,
           "hd80_erf": dict(HD80, gelu_exact=True)}
FEAT_TOL = 1e-5     # f32 unit features; measured ~2e-7
# int8 towers: the f32 activations entering each quantizer differ by ~1e-6
# between the two sides (sums in another order), and a value that close to
# a rounding boundary takes the neighbouring code.  One such flip moves one
# product term by one activation step (max|x| / 127): unit features then
# differ by up to 3.1e-3 (measured over 8 seeds of both test configs), with
# every other element within 1e-7.  With the same inputs the codes are
# equal (tests/test_torch_quant.py).
INT8_TOL, INT8_MIN_COS = 1e-2, 0.9995
_init = jax.jit(JC.init_params, static_argnums=0)
_encode = {fn: jax.jit(fn, static_argnames=("cfg", "normalize"))
           for fn in (JC.encode_image, JC.encode_text)}


def _jax_init(cfg, seed=0):
    """numpy (params, int8-quantized params) of ``clip.init_params``.
    ``quantize_params`` runs eagerly, as ``CLIPMatcher`` runs it: under
    ``jit`` XLA turns its ``/ 127.0`` into a multiply by f32(1/127), which
    moves some scales by an ulp."""
    p = _init(cfg, jax.random.PRNGKey(seed))
    return tuple(jax.tree_util.tree_map(np.asarray, t)
                 for t in (p, JC.quantize_params(p)))


@pytest.fixture(scope="module")
def jax_params():
    """name -> (numpy params, numpy int8-quantized params); the erf-GELU
    config shares the hd80 weights."""
    out = {n: _jax_init(JC.CLIPConfig(**CONFIGS[n]))
           for n in ("vitb32_test", "hd80")}
    out["hd80_erf"] = out["hd80"]
    return out


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


ACTIVATION = ("gelu_exact", "quick_gelu")
# presets whose activation the port states as published where the JAX
# package's states the tanh form (ROADMAP, "Deliberate divergences"):
# MetaCLIP ViT-H/14 is published with quick GELU (open_clip
# ViT-H-14-quickgelu, HF hidden_act quick_gelu)
PUBLISHED_ACTIVATION = {"METACLIP_VITH14": {"gelu_exact": False,
                                            "quick_gelu": True}}


def _but_activation(cfg, name):
    """The preset's fields, its activation left out where it diverges."""
    out = dataclasses.asdict(cfg)
    if name in PUBLISHED_ACTIVATION:
        for k in ACTIVATION:
            out.pop(k)
    return out


@pytest.mark.parametrize("name", ["METACLIP_VITH14", "CLIP_VITB32_TEST",
                                  "SD3_CLIP_L", "SD3_CLIP_G",
                                  "SD3_CLIP_L_TEST", "SD3_CLIP_G_TEST"])
def test_configs_match_jax(name):
    """Every field of every preset equals the JAX package's, but the
    activation of a preset that diverges, which is the published one."""
    j, t = getattr(JC, name), getattr(TC, name)
    assert ([(f.name, f.default) for f in dataclasses.fields(t)]
            == [(f.name, f.default) for f in dataclasses.fields(j)])
    assert _but_activation(t, name) == _but_activation(j, name)
    if name in PUBLISHED_ACTIVATION:
        assert {k: getattr(t, k) for k in ACTIVATION} == \
            PUBLISHED_ACTIVATION[name]
        assert {k: getattr(j, k) for k in ACTIVATION} != \
            PUBLISHED_ACTIVATION[name]
    else:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.grid == j.grid
    # CONFIGS' keys are the presets' names in lower case
    assert {k: _but_activation(v, k.upper()) for k, v in TC.CONFIGS.items()} \
        == {k: _but_activation(v, k.upper()) for k, v in JC.CONFIGS.items()}


@pytest.mark.parametrize("name", ["DINOV2_VITS14_REG", "DINOV2_VITB14_REG",
                                  "DINOV2_VITL14_REG", "DINOV2_VITG14_REG"])
def test_vit_configs_match_jax(name):
    """Every field of every DINOv2 preset equals the JAX package's, but
    ViT-L's activation, the exact (erf) GELU as published (``nn.GELU``)
    where JAX's states the tanh form (ROADMAP, "Deliberate
    divergences"): the habitat world builds ViT-L from it."""
    from bsc_nav_tpu.models import vit as JV
    from bsc_nav_tpu_torch.models import vit as TV
    j, t = getattr(JV, name), getattr(TV, name)
    assert ([(f.name, f.default) for f in dataclasses.fields(t)]
            == [(f.name, f.default) for f in dataclasses.fields(j)])
    ours, theirs = dataclasses.asdict(t), dataclasses.asdict(j)
    if name == "DINOV2_VITL14_REG":
        assert ours.pop("gelu_exact") is True
        assert theirs.pop("gelu_exact") is False
    assert ours == theirs
    assert TV.CONFIGS[name.lower()] is t


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_encoders_match_jax(jax_params, name, int8):
    """encode_image and encode_text, f32 towers within FEAT_TOL (raw
    features, O(1)-O(10), within 1e-5 abs + 1e-5 rel), int8 W8A8 towers
    within INT8_TOL and INT8_MIN_COS."""
    kw = CONFIGS[name]
    jcfg, tcfg = JC.CLIPConfig(**kw), TC.CLIPConfig(**kw)
    params = jax_params[name][int(int8)]
    model = clip_from_jax_params(params, tcfg, device="cpu")
    assert model.quantized == ("both" if int8 else "none")
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(3, jcfg.image_size, jcfg.image_size, 3)
                      ).astype(np.float32)
    ids = rng.integers(1, jcfg.vocab_size, size=(3, jcfg.context_length)
                       ).astype(np.int32)
    ids[0, 5] = ids[0, 9] = jcfg.vocab_size - 1     # EOT twice: first wins
    jp = _jnp(params)
    for jfn, tfn, x in ((JC.encode_image, TC.encode_image, imgs),
                        (JC.encode_text, TC.encode_text, ids)):
        want = np.asarray(_encode[jfn](jp, jnp.asarray(x), cfg=jcfg,
                                       normalize=False))
        raw = tfn(model, torch.from_numpy(x), tcfg, normalize=False)
        got = tfn(model, torch.from_numpy(x), tcfg)
        assert got.dtype == torch.float32
        unit = want / np.linalg.norm(want, axis=-1, keepdims=True)
        if int8:
            np.testing.assert_allclose(got.numpy(), unit, atol=INT8_TOL)
            assert (got.numpy() * unit).sum(-1).min() >= INT8_MIN_COS
            continue
        np.testing.assert_allclose(raw.numpy(), want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), unit, atol=FEAT_TOL, rtol=0)


@pytest.mark.parametrize("name", ["SD3_CLIP_L_TEST", "SD3_CLIP_G_TEST"])
def test_encode_text_sd3_matches_jax(name):
    """Penultimate hidden states (O(1) activations) and the unnormalized
    pooled projection: 1e-5 abs + 1e-5 rel (quick_gelu in CLIP-L)."""
    jcfg, tcfg = getattr(JC, name), getattr(TC, name)
    # init_text_params draws the text tower from the same keys whatever the
    # vision fields, so a one-layer vision side keeps the test small
    small = dict(dataclasses.asdict(jcfg), vision_width=16, vision_layers=1,
                 vision_heads=1, image_size=28)
    params = _jax_init(JC.CLIPConfig(**small), seed=3)[0]
    tp = params["text"]
    tower = clip_from_jax_params(params, TC.CLIPConfig(**small),
                                 device="cpu").text
    fresh = TC.init_text_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    assert {k: v.shape for k, v in fresh.state_dict().items()} == {
        k: v.shape for k, v in tower.state_dict().items()}
    rng = np.random.default_rng(2)
    ids = rng.integers(1, jcfg.vocab_size - 1,
                       size=(2, jcfg.context_length)).astype(np.int32)
    ids[:, 7] = jcfg.vocab_size - 1
    jpen, jpool = jax.jit(JC.encode_text_sd3, static_argnames="cfg")(
        _jnp(tp), jnp.asarray(ids), cfg=jcfg)
    tpen, tpool = TC.encode_text_sd3(tower, torch.from_numpy(ids), tcfg)
    np.testing.assert_allclose(tpen.numpy(), np.asarray(jpen), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("hw,size,atol", [
    (70, 32, 1e-5), (32, 32, 1e-6),
    # 680 -> 224: JAX's own f32 resize is off a float64 evaluation of the
    # same matrices by ~1.1e-5 before normalization (tests/test_torch_vit.py)
    (680, 224, 1e-4)])
def test_preprocess_matches_jax(hw, size, atol):
    """Antialiased bilinear resize + open_clip normalization on values of
    magnitude ~2."""
    cfg = dataclasses.replace(JC.CLIP_VITB32_TEST, image_size=size)
    rng = np.random.default_rng(hw)
    imgs = rng.integers(0, 256, size=(1, hw, hw, 3), dtype=np.uint8)
    want = np.asarray(JC.preprocess(jnp.asarray(imgs), cfg))
    got = TC.preprocess(torch.from_numpy(imgs), TC.CLIPConfig(
        **dataclasses.asdict(cfg)))
    assert got.shape == (1, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_quantize_params_matches_jax(jax_params, tmp_path):
    """The port's quantize_params gives JAX's leaves exactly, leaves its
    input as it is, and a converted .npz (plain or quantized) loads into
    the same state."""
    params, qparams = jax_params["hd80"]
    cfg = TC.CLIPConfig(**HD80)
    model = clip_from_jax_params(params, cfg, device="cpu")
    q = TC.quantize_params(model)
    want = clip_from_jax_params(qparams, cfg, device="cpu").state_dict()
    got = q.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)
    assert "visual.blocks.0.qkv.w" in model.state_dict()
    assert TC.quantize_params(model, "visual").text.blocks[0].qkv.w_q is None
    for tree, name in ((params, "plain"), (qparams, "int8")):
        path = str(tmp_path / f"{name}.npz")
        save_params_npz(_jnp(tree), path)
        loaded = load_clip_npz(path, cfg, device="cpu").state_dict()
        ref = clip_from_jax_params(tree, cfg, device="cpu").state_dict()
        for k in ref:
            torch.testing.assert_close(loaded[k], ref[k], rtol=0, atol=0)


@pytest.mark.parametrize("quantize", [False, True])
def test_clip_matcher_matches_jax(jax_params, quantize):
    """score (text and image prompts) and best against the JAX matcher;
    scores are softmaxes of unit-feature dots: 1e-5 abs in f32, 1e-3 in
    int8 (a flipped code moves a dot by up to ~3e-3, see INT8_TOL)."""
    params = jax_params["hd80"][0]
    jcfg, tcfg = JC.CLIPConfig(**HD80), TC.CLIPConfig(**HD80)
    tok = HashTokenizer(vocab_size=512, context_length=16)
    jm = JMatcher(_jnp(params), jcfg, tok, quantize=quantize)
    tm = CLIPMatcher(clip_from_jax_params(params, tcfg, device="cpu"),
                     tcfg, tok,
                     quantize=quantize)
    rng = np.random.default_rng(4)
    views = list(rng.integers(0, 256, size=(5, 64, 64, 4), dtype=np.uint8))
    for prompt in ("a bed", views[2][:, :, :3]):
        got, want = tm.score(views, prompt), jm.score(views, prompt)
        assert got.shape == (5,) and abs(got.sum() - 1) < 1e-5
        np.testing.assert_allclose(got, want, atol=1e-3 if quantize else 1e-5,
                                   rtol=0)
    labels = list(HM3D_DETECT_CLASSES)
    assert tm.best("a bed", labels) == jm.best("a bed", labels)
    np.testing.assert_allclose(tm._embed_text(labels),
                               jm._embed_text(labels),
                               atol=INT8_TOL if quantize else FEAT_TOL)
    assert set(tm._text_cache) == set(labels) | {"a bed"}


def test_models_stay_on_their_device(jax_params):
    model = clip_from_jax_params(jax_params["hd80"][0],
                                 TC.CLIPConfig(**HD80), device="cpu")
    tok = HashTokenizer(vocab_size=512, context_length=16)
    # no card here: asking for one raises; on a card host the CPU weights
    # do not move there quietly
    with pytest.raises((RuntimeError, ValueError)):
        CLIPMatcher(model, model.cfg, tok, device="cuda")
    with pytest.raises((RuntimeError, ValueError)):
        ClipPatchDetector(model, model.cfg, tok, ["bed"], device="cuda")
    assert CLIPMatcher(model, model.cfg, tok, device="cpu").device.type \
        == "cpu"


def test_clip_patch_detector_matches_jax(jax_params):
    """Dense patch embeddings (unit vectors) within FEAT_TOL; detections
    equal (labels, boxes; confidence within 1e-4) on every frame whose
    heat map keeps 1e-4 away from the threshold and whose per-patch best
    class leads the second by 1e-4 (the x100 softmax turns 1e-6 in a
    cosine into 1e-4 in a heat value)."""
    params = jax_params["hd80"][0]
    jcfg, tcfg = JC.CLIPConfig(**HD80), TC.CLIPConfig(**HD80)
    tok = HashTokenizer(vocab_size=512, context_length=16)
    classes, conf = list(HM3D_DETECT_CLASSES), 0.55
    jd = JDetector(_jnp(params), jcfg, tok, classes, conf)
    td = ClipPatchDetector(clip_from_jax_params(params, tcfg, device="cpu"),
                           tcfg, tok,
                           classes, conf)
    np.testing.assert_allclose(td.text_emb, jd.text_emb, atol=FEAT_TOL)
    rng = np.random.default_rng(5)
    rgbs = rng.integers(0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    want_emb = np.asarray(jd._dense(jd.params, jnp.asarray(rgbs)))
    got_emb = td.embed(rgbs)
    assert got_emb.shape == (4, jcfg.grid ** 2, jcfg.embed_dim)
    np.testing.assert_allclose(got_emb, want_emb, atol=FEAT_TOL)

    got, want = td.detect_batch(rgbs), jd.detect_batch(rgbs)
    compared = 0
    for b in range(len(rgbs)):
        sims = want_emb[b] @ jd.text_emb.T * 100.0
        p = np.exp(sims - sims.max(axis=1, keepdims=True))
        p = np.sort(p / p.sum(axis=1, keepdims=True), axis=1)
        if (np.abs(p[:, -1] - conf).min() <= 1e-4
                or (p[:, -1] - p[:, -2]).min() <= 1e-4):
            continue
        compared += 1
        assert [(d.label, d.xyxy) for d in got[b]] == [
            (d.label, d.xyxy) for d in want[b]]
        np.testing.assert_allclose([d.confidence for d in got[b]],
                                   [d.confidence for d in want[b]],
                                   atol=1e-4)
    assert compared >= 3 and sum(map(len, want)) > 0


def _jax_dense(params, images_uint8, cfg):
    """The JAX detector's dense path (``bsc_nav_tpu/models/detector.py:
    93-118``) with the activation ``cfg`` states passed to JAX's
    ``clip._tower_forward``; the JAX detector itself takes the tanh form."""
    from bsc_nav_tpu.models.vit import _linear, layer_norm, patchify
    v = params["visual"]
    h = _linear(patchify(JC.preprocess(images_uint8, cfg), cfg.patch_size),
                v["patch_embed"])
    cls = jnp.broadcast_to(v["class_embedding"][None, None, :],
                           (h.shape[0], 1, cfg.vision_width)).astype(h.dtype)
    h = jnp.concatenate([cls, h], axis=1) + v["pos_embed"][None]
    h = layer_norm(h, v["ln_pre"], cfg.ln_eps)
    h = JC._tower_forward(h, v["blocks"][:-1], cfg.vision_heads, cfg.ln_eps,
                          gelu_exact=cfg.gelu_exact,
                          quick_gelu=cfg.quick_gelu)
    blk = v["blocks"][-1]
    val = _linear(layer_norm(h, blk["ln1"], cfg.ln_eps), blk["qkv"])
    val = _linear(val[..., 2 * cfg.vision_width:], blk["proj"]) + h
    val = layer_norm(val, v["ln_post"], cfg.ln_eps)
    emb = jnp.einsum("bsd,de->bse", val, v["proj"],
                     preferred_element_type=jnp.float32)
    emb = emb / jnp.maximum(jnp.linalg.norm(emb, axis=-1, keepdims=True),
                            1e-12)
    return np.asarray(emb[:, 1:])


@pytest.mark.parametrize("act", ["quick_gelu", "gelu_exact", "tanh"])
def test_dense_embed_follows_the_activation(jax_params, act):
    """The port's dense path takes the configuration's activation: unit
    patch embeddings within FEAT_TOL of JAX's dense path given the same
    activation, and further than 1e-5 from it under another."""
    from bsc_nav_tpu_torch.models.detector import dense_embed
    kw = dict(HD80, gelu_exact=act == "gelu_exact",
              quick_gelu=act == "quick_gelu")
    jcfg, tcfg = JC.CLIPConfig(**kw), TC.CLIPConfig(**kw)
    params = jax_params["hd80"][0]
    model = clip_from_jax_params(params, tcfg, device="cpu")
    rgbs = np.random.default_rng(6).integers(0, 256, size=(2, 64, 64, 3),
                                             dtype=np.uint8)
    got = dense_embed(model, torch.from_numpy(rgbs), tcfg).numpy()
    np.testing.assert_allclose(got, _jax_dense(_jnp(params),
                                               jnp.asarray(rgbs), jcfg),
                               atol=FEAT_TOL, rtol=0)
    other = JC.CLIPConfig(**dict(kw, quick_gelu=act != "quick_gelu",
                                 gelu_exact=False))
    assert np.abs(got - _jax_dense(_jnp(params), jnp.asarray(rgbs),
                                   other)).max() > 1e-5


def test_clip_slice_never_imports_jax():
    """The matcher, the detector and its long-term feed run without JAX."""
    code = (
        "import sys, numpy as np, torch\n"
        "from bsc_nav_tpu_torch.config import small_test_config\n"
        "from bsc_nav_tpu_torch.models.tokenizer import HashTokenizer\n"
        "from bsc_nav_tpu_torch.agents.matchers import CLIPMatcher\n"
        "from bsc_nav_tpu_torch.agents.spatial_memory import "
        "Perception, VoxelTokenMemory\n"
        "from bsc_nav_tpu_torch.models import clip as C, vit\n"
        "from bsc_nav_tpu_torch.models.detector import ClipPatchDetector\n"
        "cfg = small_test_config()\n"
        f"cc = C.CLIPConfig(**{HD80!r})\n"
        "clip = C.init_params(cc, torch.Generator().manual_seed(0), "
        "device='cpu')\n"
        "tok = HashTokenizer(512, 16)\n"
        "rng = np.random.default_rng(0)\n"
        "views = list(rng.integers(0, 255, (3, 64, 64, 3), np.uint8))\n"
        "assert CLIPMatcher(clip, cc, tok, quantize=True).score(views, "
        "'a bed').shape == (3,)\n"
        "det = ClipPatchDetector(clip, cc, tok, ['bed', 'sofa'], 0.3)\n"
        "vc = vit.ViTConfig(img_size=28, dim=32, depth=1, heads=2)\n"
        "m = VoxelTokenMemory(cfg, None, Perception.create(cfg, vc, "
        "batch_size=2, device='cpu'), detector=det)\n"
        "for i in range(3):\n"
        "    m.push_frame({'rgb': rng.integers(0, 255, (64, 64, 3), "
        "np.uint8), 'depth': rng.uniform(0.5, 3, (64, 64)).astype("
        "np.float32)}, np.array([0, 0, 0, 0, 0, 0, 1], np.float32))\n"
        "m.flush()\n"
        "assert len(m.long_memory_dict) > 0\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax')))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
