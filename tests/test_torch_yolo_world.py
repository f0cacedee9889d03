"""Port parity: YOLO-World (bsc_nav_tpu/models/yolo_world.py) and the int8
convolution (bsc_nav_tpu/ops/quant.py conv_q8) against the JAX package, at
YOLO_TEST (64^2, width 0.125) with JAX-initialised params handed across
by ``yolo_world_from_jax_params``.

The numpy params get random conv BN statistics (so that the fold K8's
route applies is not the identity) and random head statistics, logit
scales and biases (so that confidences do not tie: with the JAX init they
all equal sigmoid(-10) and ``lax.top_k`` / a stable sort would then only
agree by index order).  text_dim 48 != embed_dim 32 runs ``txt_proj``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.models import yolo_world as JY
from bsc_nav_tpu.ops import quant as jq
from bsc_nav_tpu_torch.models import yolo_world as TY
from bsc_nav_tpu_torch.models.weights import yolo_world_from_jax_params
from bsc_nav_tpu_torch.ops import quant as tq
from torch_parity import yolo_numpy_params

CFG_J, CFG_T = JY.YOLO_TEST, TY.YOLO_TEST
TEXT_DIM, T = 48, 5
CLASSES = ["bed", "sofa", "chair", "plant", "table"]


@pytest.fixture(scope="module")
def model():
    params = yolo_numpy_params(CFG_J, 0, TEXT_DIM)
    rng = np.random.default_rng(1)
    text = rng.normal(size=(T, TEXT_DIM)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    fwd = jax.jit(JY.forward, static_argnums=3)
    return {"np": params, "jax": jparams,
            "torch": yolo_world_from_jax_params(params, CFG_T, device="cpu"),
            "text": text, "img": img,
            "jax_out": [tuple(map(np.asarray, o)) for o in fwd(
                jparams, jnp.asarray(img), jnp.asarray(text), CFG_J)],
            "fwd": fwd}


def _forward_torch(tparams, m):
    return [(b.numpy(), c.numpy()) for b, c in TY.forward(
        tparams, torch.from_numpy(m["img"]), torch.from_numpy(m["text"]),
        CFG_T)]


def test_forward_matches_jax(model):
    """f32 box and class logits per level: f32 sums in other orders (and
    K8's folded BN, within ``fold_bound`` a conv) through ~40 layers
    stay within 1e-5 of each level's max |logit| (measured ~2e-7 of
    ~1.6)."""
    got = _forward_torch(model["torch"], model)
    for lvl, ((jb, jc), (tb, tc)) in enumerate(zip(model["jax_out"], got)):
        s = 64 // CFG_T.strides[lvl]
        assert tb.shape == (2, s, s, 4 * CFG_T.reg_max) and tc.shape == (
            2, s, s, T)
        for a, b in ((tb, jb), (tc, jc)):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=f"level {lvl}")


def _k8_leaves(node, path, act="silu"):
    """(path, leaf, act) of every 3x3 stride-1 conv + BN leaf under node:
    the Conv blocks' SiLU, max-sigmoid attention's proj without one."""
    if isinstance(node, dict):
        if "bn_var" in node and np.ndim(node.get("w")) == 4:
            if node["w"].shape[0] == 3:
                yield path, node, act
            return
        for k, v in node.items():
            yield from _k8_leaves(v, f"{path}.{k}",
                                  "none" if k == "proj" else act)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _k8_leaves(v, f"{path}.{i}", act)


def _tree_at(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.mark.parametrize("key", ["c2f_2", "c2f_4", "c2f_6", "c2f_8", "n12",
                                 "n15", "n18", "n21", "head"])
def test_k8_route_matches_jax_unfolded_conv(model, key):
    """Every 3x3 stride-1 conv under ``key``: the route (K8's plain version
    on the BN-folded w9 / b9) against JAX's ``_conv_bn_silu`` (lax.conv,
    then the BN in f32), elementwise within ``fold_bound`` (the fold's
    two roundings, both sides' f32 sums, the affine's roundings, SiLU's
    slope)."""
    rng = np.random.default_rng(len(key))
    leaves = list(_k8_leaves(model["np"][key], key))
    assert leaves
    for path, leaf, act in leaves:
        C = leaf["w"].shape[2]
        x = rng.normal(size=(2, 8, 6, C)).astype(np.float32)
        want = np.asarray(JY._conv_bn_silu(
            jnp.asarray(x), _tree_at(model["jax"], path), act=act == "silu"))
        tleaf = _tree_at(model["torch"], path)
        assert set(tleaf) >= {"w9", "b9"}
        got = TY.conv_bn_act(torch.from_numpy(x), tleaf, act=act)
        bound = TY.fold_bound(torch.from_numpy(x), tleaf, act).numpy()
        assert np.all(np.abs(got.numpy() - want) <= bound), path


def test_fold_bound_catches_a_wrong_fold(model):
    """The bound is tight enough to see a fold with the head's eps (1e-5)
    in place of the Conv blocks' 1e-3."""
    from bsc_nav_tpu_torch.ops.conv2d import conv3x3_s1, fold_bn
    path, leaf, _ = next(_k8_leaves(model["np"]["c2f_4"], "c2f_4"))
    tleaf = _tree_at(model["torch"], path)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 8, 6, leaf["w"].shape[2])).astype(np.float32))
    want = np.asarray(JY._conv_bn_silu(jnp.asarray(x.numpy()),
                                       _tree_at(model["jax"], path)))
    w9, b9 = fold_bn(*(tleaf[k] for k in ("w", "bn_scale", "bn_bias",
                                          "bn_mean", "bn_var")), eps=1e-5)
    bad = conv3x3_s1(x, w9, b9).numpy()
    assert np.any(np.abs(bad - want) > TY.fold_bound(x, tleaf).numpy())


@pytest.mark.parametrize("k,stride,C,CO,HW", [(3, 1, 24, 40, 9),
                                              (3, 2, 24, 40, 9),
                                              (3, 2, 16, 8, 10),
                                              (1, 1, 48, 16, 6)])
def test_conv_q8_equals_jax(k, stride, C, CO, HW):
    """Equal inputs give equal int8 codes, exact int32 sums and the same
    f32 epilogue: exactly equal outputs, "SAME" padding at stride 2
    (odd and even sizes) included."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, HW, HW, C)).astype(np.float32)
    x[1] *= 3.0                               # a scale per sample
    p = {"w": (rng.normal(size=(k, k, C, CO)) / np.sqrt(k * k * C)
               ).astype(np.float32)}
    jp = jq.quantize_conv_weight({"w": jnp.asarray(p["w"])})
    tp = tq.quantize_conv_weight({"w": torch.from_numpy(p["w"])})
    np.testing.assert_array_equal(tp["w_q"].numpy(), np.asarray(jp["w_q"]))
    np.testing.assert_array_equal(tp["w_s"].numpy(), np.asarray(jp["w_s"]))
    want = np.asarray(jq.conv_q8(jnp.asarray(x), jp, stride))
    got = tq.conv_q8(torch.from_numpy(x), tp, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_neck_quantized_forward_matches_jax(model):
    """``quantize_params`` (scope "neck"): the same leaves quantized to the
    same codes; the whole forward within 2e-3 of each level's max |logit|:
    f32 noise of ~1e-7 may flip an activation code that sits at a
    rounding boundary, and a flipped code moves a logit by ~1e-3 (the
    CLIP towers' INT8_TOL reasoning; measured equal to ~2e-7 here)."""
    jq_params = JY.quantize_params(model["jax"])
    tq_params = TY.quantize_params(model["torch"])
    for key in ("n12", "head"):
        jl = list(_k8_leaves(jax.tree_util.tree_map(np.asarray,
                                                    jq_params[key]), key))
        assert not jl            # quantized leaves have no "w"
    leaf_j = jq_params["n15"]["m"][0]["cv1"]
    leaf_t = tq_params["n15"]["m"][0]["cv1"]
    assert "w9" not in leaf_t and "w_q" in leaf_t
    np.testing.assert_array_equal(leaf_t["w_q"].numpy(),
                                  np.asarray(leaf_j["w_q"]))
    assert "w9" in tq_params["c2f_2"]["m"][0]["cv1"]      # backbone float
    want = model["fwd"](jq_params, jnp.asarray(model["img"]),
                        jnp.asarray(model["text"]), CFG_J)
    got = _forward_torch(tq_params, model)
    for (jb, jc), (tb, tc) in zip(want, got):
        for a, b in ((tb, np.asarray(jb)), (tc, np.asarray(jc))):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2e-3 * np.abs(b).max())


def _synthetic_levels(seed, img_size=640):
    """Level outputs of a 640^2 frame (8,400 anchors) from the seed: box
    logits N(0, 3); one class an anchor with a logit from a shuffled
    linspace(-4, 4) (confidences at least 1.7e-5 apart), the others
    N(-10, 0.5) below it."""
    rng = np.random.default_rng(seed)
    sizes = [(img_size // s) ** 2 for s in CFG_J.strides]
    best = rng.permutation(np.linspace(-4, 4, 2 * sum(sizes)))
    out, at = [], 0
    for s, n in zip(CFG_J.strides, sizes):
        g = img_size // s
        cls = rng.normal(-10, 0.5, size=(2 * n, T))
        cls[np.arange(2 * n), rng.integers(0, T, 2 * n)] = best[at:at + 2 * n]
        at += 2 * n
        out.append((rng.normal(0, 3, size=(2, g, g, 64)).astype(np.float32),
                    cls.reshape(2, g, g, T).astype(np.float32)))
    return out


def _levels(model, source):
    return model["jax_out"] if source == "forward" else _synthetic_levels(4)


@pytest.mark.parametrize("source", ["forward", "synthetic-640"])
def test_decode_and_device_nms_match_jax(model, source):
    """Given JAX's level outputs: ``dfl_decode`` within 2e-5 (distances in
    [0, 15] from f32 exponentials, a normalisation and a 16-term sum, ~16
    ulps at 15 on each side); the top-k candidates' confidences (distinct
    by more than 1e-6, so the order is not a tie-break) within 1e-6, boxes
    within 1e-3 px (2e-5 times strides up to 32), classes equal (and the
    host ``decode_boxes``' boxes and scores within 1e-3);
    ``nms_device`` keeps the same candidates, given no same-class IoU
    within 1e-6 of the 0.5 threshold (where f32 rounding may decide)."""
    levels = _levels(model, source)
    jl = [tuple(map(jnp.asarray, o)) for o in levels]
    tl = [tuple(torch.tensor(a) for a in o) for o in levels]
    np.testing.assert_allclose(
        TY.dfl_decode(tl[0][0], 16).numpy(),
        np.asarray(JY.dfl_decode(jl[0][0], 16)), atol=2e-5, rtol=0)
    cfg = JY.YoloWorldConfig(img_size=64 if source == "forward" else 640)
    k = 64 if source == "forward" else 256
    jb, jc, ji = (np.asarray(a) for a in JY.decode_topk_device(jl, cfg, k))
    tb, tc, ti = TY.decode_topk_device(tl, TY.YoloWorldConfig(
        img_size=cfg.img_size), k)
    assert np.all(-np.diff(jc, axis=1) > 1e-6)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(ti.numpy(), ji)

    if source == "forward":                   # the host decode of frame 0
        for g, w in zip(TY.decode_boxes(tl, CFG_T), JY.decode_boxes(jl,
                                                                    CFG_J)):
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)

    thr = float(np.median(jc))
    want = [np.asarray(a) for a in JY.nms_device(
        jnp.asarray(jb), jnp.asarray(jc), jnp.asarray(ji), 0.5, thr, k)]
    got = [a.numpy() for a in TY.nms_device(
        torch.from_numpy(jb), torch.from_numpy(jc), torch.from_numpy(ji),
        0.5, thr, k)]
    for b in range(2):
        iou = TY.iou_xyxy(jb[b].astype(np.float64), jb[b].astype(np.float64))
        same = ji[b][:, None] == ji[b][None, :]
        assert np.abs(iou[same] - 0.5).min() > 1e-6
    np.testing.assert_array_equal(got[3], want[3])
    assert 0 < got[3].sum() < got[3].size
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g[got[3]], w[want[3]])


def test_host_nms_matches_jax():
    """iou_xyxy within 1e-12 (float64 on both sides) and the same kept
    indices, over boxes with overlaps on both sides of 0.5."""
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 100, size=(60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, size=(60, 2))], 1)
    scores = rng.uniform(size=60)
    np.testing.assert_allclose(TY.iou_xyxy(boxes, boxes),
                               JY.iou_xyxy(boxes, boxes), atol=1e-12)
    for thr in (0.3, 0.5, 0.7):
        assert TY.nms(boxes, scores, thr) == JY.nms(boxes, scores, thr)


def test_detect_batch_matches_jax(model):
    """The detector protocol at 96x128 frames (resized to 64^2): the same
    detections per frame, labels and order equal, confidences within 1e-5,
    boxes within 1e-3 px; and ``_nms_detections`` on equal candidates
    gives equal detections."""
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, size=(3, 96, 128, 3), dtype=np.uint8)
    kw = dict(classes=CLASSES, text_embeddings=model["text"],
              confidence=0.6, iou_thr=0.5)
    jdet = JY.YoloWorldDetector(model["jax"], CFG_J, **kw)
    tdet = TY.YoloWorldDetector(model["torch"], CFG_T, **kw)
    want, got = jdet.detect_batch(imgs), tdet.detect_batch(imgs)
    assert sum(map(len, want)) > 3
    for w, g in zip(want, got):
        assert [d.label for d in g] == [d.label for d in w]
        np.testing.assert_allclose([d.confidence for d in g],
                                   [d.confidence for d in w], atol=1e-5)
        np.testing.assert_allclose(np.reshape([d.xyxy for d in g], (-1, 4)),
                                   np.reshape([d.xyxy for d in w], (-1, 4)),
                                   atol=1e-3)
    boxes = rng.uniform(0, 60, size=(40, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    cls = rng.integers(0, 3, size=40)
    conf = rng.uniform(0.5, 1, size=40).astype(np.float32)
    assert ([tuple(vars(d).values())
             for d in tdet._nms_detections(boxes, cls, conf, 96, 128)]
            == [tuple(vars(d).values())
                for d in jdet._nms_detections(boxes, cls, conf, 96, 128)])
