"""Port parity: Grounding DINO (bsc_nav_tpu/models/grounding_dino.py) against
the JAX package on the CPU, at tests/test_grounding_dino.py's TINY.

One seeded numpy tree goes to both sides (``torch_worlds.
gdino_numpy_params``: the port's ``init_params``, the JAX init's tree and
distributions, with the biases, norms and fusion layer scales redrawn; JAX's
eager init would take ~15 s).  The
JAX references are computed once per module, under ``jax.jit`` (eager JAX
takes ~50 s for the tiny forward).  Tolerances: the backbone at JAX's own
bound against HF (rtol 2e-4, atol 3e-5), everything else at rtol 1e-3,
atol 2e-4 (JAX's forward bound against HF) or tighter where stated; f32
sums in other orders measure ~1e-6 relative.  Every float decision (the
two-stage top-k, a detection's class, NMS) is held to a margin stated in
its test.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.models import grounding_dino as JG
from bsc_nav_tpu.models.weights import save_params_npz
from bsc_nav_tpu_torch.models import grounding_dino as TG
from bsc_nav_tpu_torch.models import weights as TW
from test_grounding_dino import TINY
from torch_worlds import GDINO_TINY, gdino_numpy_params

# "[CLS] w w . w . [SEP]" and "[CLS] w . w w . [SEP] [PAD]" (a padded row)
IDS = np.array([[101, 7, 8, 1012, 9, 1012, 102, 0],
                [101, 7, 1012, 9, 9, 1012, 102, 0]], np.int64)
TOKEN_MASK = np.array([[1] * 8, [1] * 7 + [0]], bool)
DET_IDS = np.array([[101, 7, 1012, 9, 1012, 102]], np.int64)


def _margin(x, k):
    """Gap between the k-th and (k+1)-th largest per row."""
    s = -np.sort(-x, axis=-1)
    return float((s[..., k - 1] - s[..., k]).min())


@pytest.fixture(scope="module")
def m():
    npp = gdino_numpy_params(GDINO_TINY, 0)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    rng = np.random.default_rng(2)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    attn, pos = JG.generate_text_masks(IDS)
    text = (IDS, np.zeros_like(IDS), attn, pos, TOKEN_MASK)
    fwd = jax.jit(lambda p, x, *t: JG.forward(p, x, *t, TINY))
    swin = jax.jit(lambda p, x: [f for f, _ in JG.swin_backbone(
        p, x, TINY.swin)])
    bert = jax.jit(lambda p, *a: JG.bert_encode(p, *a, TINY.text))
    jt = [jnp.asarray(a) for a in text]
    return {
        "np": npp, "img": img, "text": text,
        "torch": TW.grounding_dino_from_jax_params(npp, GDINO_TINY,
                                                   device="cpu"),
        "forward": {k: np.asarray(v) for k, v in fwd(
            jp, jnp.asarray(img), *jt).items()},
        "swin": [np.asarray(f) for f in swin(jp["backbone"],
                                              jnp.asarray(img))],
        "bert": np.asarray(bert(jp["text"], *jt[:1], jt[1], jt[3], jt[2])),
        "jax_params": jp,
    }


def _ttext(text):
    ids, types, attn, pos, mask = (torch.from_numpy(a) for a in text)
    return ids, types, attn, pos, mask


def test_configs_and_host_parts_are_copies():
    """The port's configs, special ids, TINY, index tables, text masks,
    phrase map and phrase scores equal the JAX module's."""
    asdict = dataclasses.asdict
    assert asdict(TG.GROUNDING_DINO_TINY) == asdict(JG.GROUNDING_DINO_TINY)
    assert asdict(GDINO_TINY) == asdict(TINY)
    assert TG.GROUNDING_DINO_TINY.fusion_heads == 4
    assert TG.SPECIAL_TOKEN_IDS == JG.SPECIAL_TOKEN_IDS
    for w in (4, 7):
        np.testing.assert_array_equal(TG._swin_rel_pos_index(w),
                                      JG._swin_rel_pos_index(w))
    for hp, wp, w, s in ((8, 8, 4, 2), (203, 203, 7, 3), (28, 28, 7, 3)):
        ref = JG._swin_shift_mask(hp, wp, w, s)
        np.testing.assert_array_equal(TG._swin_shift_mask(hp, wp, w, s), ref)
    rng = np.random.default_rng(0)
    ids = np.concatenate([IDS, [[101, 1029, 5, 5, 1012, 6, 102, 102]]])
    for a, b in zip(TG.generate_text_masks(ids),
                    JG.generate_text_masks(ids)):
        np.testing.assert_array_equal(a, b)
    for row in ids:
        lm = TG.phrase_label_map(row)
        np.testing.assert_array_equal(lm, JG.phrase_label_map(row))
        lg = rng.normal(scale=30, size=(5, 32)).astype(np.float32)
        np.testing.assert_array_equal(TG.scores_per_phrase(lg, lm),
                                      JG.scores_per_phrase(lg, lm))


def test_init_params_has_the_jax_tree():
    """init_params draws a tree with the JAX init's paths, shapes and
    integer index tables (JAX's side by ``jax.eval_shape``)."""
    tp = TW.flatten_params(TG.init_params(
        GDINO_TINY, torch.Generator().manual_seed(0), device="cpu"))
    leaves = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: JG.init_params(TINY, jax.random.PRNGKey(0))))[0]
    jp = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path): leaf for path, leaf in leaves}
    assert sorted(tp) == sorted(jp)
    for k, leaf in jp.items():
        assert tp[k].shape == leaf.shape, k
        assert (tp[k].dtype.kind == "i") == (leaf.dtype.kind == "i"), k
        if k.endswith("rpb_index"):
            np.testing.assert_array_equal(
                tp[k], JG._swin_rel_pos_index(TINY.swin.window_size))


def test_swin_backbone_per_stage_matches_jax(m):
    """Plain and shifted windows, padding at sub-window stages (2x2 padded
    to 4x4), patch merging and the per-stage output norms: each out stage
    within rtol 2e-4, atol 3e-5 (the JAX test's bound against HF)."""
    got = TG.swin_backbone(m["torch"]["backbone"], torch.from_numpy(m["img"]),
                           GDINO_TINY.swin)
    assert len(got) == len(m["swin"]) == 3
    for (f, hw), ref in zip(got, m["swin"]):
        assert tuple(f.shape) == ref.shape and hw == ref.shape[1:3]
        np.testing.assert_allclose(f.numpy(), ref, rtol=2e-4, atol=3e-5)


def test_bert_matches_jax(m):
    """BERT over the phrase-grouped 3-D mask, a padded row included."""
    ids, types, attn, pos, _ = _ttext(m["text"])
    got = TG.bert_encode(m["torch"]["text"], ids, types, pos, attn,
                         GDINO_TINY.text)
    np.testing.assert_allclose(got.numpy(), m["bert"], rtol=1e-3, atol=2e-4)


def _deform_case(rng, ref_dim):
    """Queries, values, references and offsets that put samples inside,
    exactly on the border (references 0 and 1 with zero offsets: pixel
    -0.5 and w - 0.5) and past it (up to 0.3 beyond)."""
    B, Q, D, heads, P = 2, 9, 32, 4, 2
    shapes = [(8, 8), (4, 4), (2, 2), (1, 1)]
    L = len(shapes)
    N = sum(h * w for h, w in shapes)
    rng_w = lambda fi, fo, s=1.0: {
        "w": (s * rng.normal(size=(fi, fo)) / np.sqrt(fi)).astype(np.float32),
        "b": (0.1 * rng.normal(size=fo)).astype(np.float32)}
    p = {"sampling_offsets": rng_w(D, heads * L * P * 2, 3.0),
         "attention_weights": rng_w(D, heads * L * P),
         "value_proj": rng_w(D, D), "output_proj": rng_w(D, D)}
    query = rng.normal(size=(B, Q, D)).astype(np.float32)
    value = rng.normal(size=(B, N, D)).astype(np.float32)
    ref = rng.uniform(-0.3, 1.3, size=(B, Q, L, ref_dim)).astype(np.float32)
    if ref_dim == 4:
        ref[..., 2:] = rng.uniform(0.05, 0.6, size=(B, Q, L, 2))
    ref[:, 0, :, :2] = 0.0                              # on the border
    ref[:, 1, :, :2] = 1.0
    query[:, :2] = 0.0                                  # offsets = bias
    p["sampling_offsets"]["b"][:] = 0.0                 # ... = 0 there
    return query, value, ref, shapes, p, heads, P


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_deformable_attention_matches_jax(ref_dim):
    """_deform_attention alone (grid_sample per level against JAX's quad
    gather) with 2-point and 4-point (box) references, samples on and past
    the border: within atol 1e-5 of outputs of ~1 (measured ~1e-7)."""
    query, value, ref, shapes, p, heads, P = _deform_case(
        np.random.default_rng(10 + ref_dim), ref_dim)
    fn = jax.jit(lambda q, v, r, p: JG._deform_attention(
        q, v, r, shapes, p, heads, P))
    want = np.asarray(fn(jnp.asarray(query), jnp.asarray(value),
                         jnp.asarray(ref), jax.tree_util.tree_map(
                             jnp.asarray, p)))
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    got = TG._deform_attention(torch.from_numpy(query),
                               torch.from_numpy(value),
                               torch.from_numpy(ref), shapes, tp, heads, P)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bi_attention_global_max_and_padding_match_jax():
    """_bi_attention at B 2 with a padded text row: frame 0's features
    scaled so that its scores exceed frame 1's by more than the +-50,000
    clip.  The max over the whole tensor then clips all of frame 1's
    scores to one value; the port matches JAX there (rtol 1e-3, atol
    2e-4), and frame 1 alone (its own max) gives another result."""
    cfg = TINY
    rng = np.random.default_rng(5)
    D, fd = cfg.d_model, cfg.fusion_dim
    lin = lambda fi, fo: {
        "w": (rng.normal(size=(fi, fo)) / np.sqrt(fi)).astype(np.float32),
        "b": (0.1 * rng.normal(size=fo)).astype(np.float32)}
    p = {k: lin(D, fd) for k in ("vision_proj", "text_proj",
                                 "values_vision_proj", "values_text_proj")}
    p.update(out_vision_proj=lin(fd, D), out_text_proj=lin(fd, D))
    v = rng.normal(size=(2, 20, D)).astype(np.float32)
    t = rng.normal(size=(2, 6, D)).astype(np.float32)
    v[0] *= 5e4
    pad = np.zeros((2, 6), bool)
    pad[1, -2:] = True
    fn = jax.jit(lambda v, t, p, m: JG._bi_attention(v, t, p, cfg, m))
    want = [np.asarray(a) for a in fn(jnp.asarray(v), jnp.asarray(t),
                                      jax.tree_util.tree_map(jnp.asarray, p),
                                      jnp.asarray(pad))]
    tp = jax.tree_util.tree_map(torch.from_numpy, p)
    got = TG._bi_attention(torch.from_numpy(v), torch.from_numpy(t), tp,
                           GDINO_TINY, torch.from_numpy(pad))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=2e-4)
    alone = TG._bi_attention(torch.from_numpy(v[1:]), torch.from_numpy(t[1:]),
                             tp, GDINO_TINY, torch.from_numpy(pad[1:]))
    assert float((alone[0] - got[0][1:]).abs().max()) > 1e-2


def test_forward_matches_jax(m):
    """The full forward's logits (-inf past the prompt and on the padded
    token) and boxes within rtol 1e-3, atol 2e-4.  The two-stage top-12
    picks the same proposals: JAX's 12th and 13th scores of each frame lie
    further apart than the port's score error."""
    ids, types, attn, pos, mask = _ttext(m["text"])
    img = torch.from_numpy(m["img"])
    got = TG.forward(m["torch"], img, ids, types, attn, pos, mask,
                     GDINO_TINY)
    want = m["forward"]
    lg, wl = got["logits"].numpy(), want["logits"]
    assert lg.shape == wl.shape == (2, 12, 32)
    np.testing.assert_array_equal(np.isneginf(lg), np.isneginf(wl))
    assert np.isneginf(lg[1, :, 7:]).all() and np.isfinite(lg[:, :, :7]).all()
    fin = np.isfinite(wl)
    np.testing.assert_allclose(lg[fin], wl[fin], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), want["pred_boxes"],
                               rtol=1e-3, atol=2e-4)
    # the selection, decided by a margin; the "select" prefix stops there
    sel = TG.forward(m["torch"], img, ids, types, attn, pos, mask,
                     GDINO_TINY, stage="select")
    np.testing.assert_array_equal(sel["topk_idx"], got["topk_idx"])
    assert _margin(sel["enc_scores"].numpy(), GDINO_TINY.num_queries) > 1e-3
    enc = TG.forward(m["torch"], img, ids, types, attn, pos, mask,
                     GDINO_TINY, stage="encoder")
    assert set(enc) == {"v_feat", "encoder_text"}
    # topk_idx= hands a given selection on
    rev = got["topk_idx"].flip(-1)
    flipped = TG.forward(m["torch"], img, ids, types, attn, pos, mask,
                         GDINO_TINY, stage="select", topk_idx=rev)
    np.testing.assert_array_equal(flipped["pred_boxes"].numpy(),
                                  sel["pred_boxes"].flip(1).numpy())


def test_detect_batch_matches_jax_detector(m):
    """GroundingDinoDetector.detect_batch at confidence 0 on two seeded
    48x48 frames (resized to 64^2 on the device): the same detections in
    the same order -- labels, confidences within 1e-5, boxes within 1e-3
    px.  Decisions held to margins: each kept query's best phrase leads
    the next by more than 1e-3 of its score (the scores' relative error is
    ~1e-5: d sigmoid / sigmoid <= d logit), and no IoU of a same-class pair lies
    within 1e-3 of the 0.5 threshold."""
    from bsc_nav_tpu.models.grounding_dino import (
        GroundingDinoDetector as JDet)
    from bsc_nav_tpu.models.yolo_world import iou_xyxy

    rgbs = np.random.default_rng(3).integers(0, 255, (2, 48, 48, 3),
                                             np.uint8)
    jdet = JDet(m["jax_params"], TINY, ["sofa", "chair"], input_ids=DET_IDS,
                confidence=0.0, image_size=64)
    tdet = TG.GroundingDinoDetector(m["torch"], GDINO_TINY,
                                    ["sofa", "chair"], input_ids=DET_IDS,
                                    confidence=0.0, image_size=64)
    want = jdet.detect_batch(rgbs)
    got = tdet.detect_batch(rgbs)
    scores, boxes = (a.numpy() for a in tdet.scores_boxes(
        tdet.images(rgbs)))
    s = -np.sort(-scores, axis=-1)
    assert ((s[..., 0] - s[..., 1]) / s[..., 0]).min() > 1e-3
    for b in range(2):
        cls = scores[b].argmax(-1)
        cxy, wh = boxes[b][:, :2], boxes[b][:, 2:]
        xyxy = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1) * 48
        for c in np.unique(cls):
            iou = iou_xyxy(xyxy[cls == c], xyxy[cls == c])
            assert np.abs(iou - 0.5).min() > 1e-3
    assert [len(d) for d in got] == [len(d) for d in want]
    assert sum(map(len, got)) > 2
    for gf, wf in zip(got, want):
        for g, w in zip(gf, wf):
            assert g.label == w.label
            assert abs(g.confidence - w.confidence) <= 1e-5
            np.testing.assert_allclose(g.xyxy, w.xyxy, rtol=0, atol=1e-3)


def test_weights_round_trip_through_npz(m, tmp_path):
    """save_params_npz (the JAX package's writer) -> load_grounding_dino_npz:
    every leaf equal to grounding_dino_from_jax_params', the index tables
    int64; a tree of another depth refused."""
    path = str(tmp_path / "grounding_dino_tiny.npz")
    save_params_npz(m["jax_params"], path)
    got = TW.flatten_params(TW.load_grounding_dino_npz(path, GDINO_TINY,
                                                       device="cpu"))
    want = TW.flatten_params(m["torch"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == (np.int64 if k.endswith("rpb_index")
                                else np.float32), k
    with pytest.raises(ValueError, match="encoder"):
        TW.grounding_dino_from_jax_params(m["np"], dataclasses.replace(
            GDINO_TINY, encoder_layers=3), device="cpu")
