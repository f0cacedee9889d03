"""The MetaCLIP patch detector of the port (``models/detector.py``, its
long-term feed in ``agents/spatial_memory.py``) against the benchmark's
plain reference (``navbench/reference/metaclip.py``) on seeded weights,
at a tiny CLIP on the CPU; a tiny traced run of the benchmark's
``build.cliph-b8`` driver, its checks and per-layer readers; and the
checks' planted faults.

Tolerances, f32 on both sides: unit patch and text embeddings within
1e-5, the configuration's ``embed_gap`` limit (the two sum their products
in other orders; measured ~1e-7 here); box confidences within 1e-4 (the
x100 softmax turns 1e-6 in a cosine into 1e-4 in a heat value); boxes and
instances equal.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from navbench import run as R
from navbench import weights_clip as WC
from navbench.drivers import memory_build as MB
from navbench.drivers import memory_build_cliph as D
from navbench.metrics import _build_shapes as BS
from navbench.metrics import _cliph_shapes as CS
from navbench.reference import metaclip as M
from navbench.tests import tiny
from torch_worlds import split_traced_run

EMBED_TOL = 1e-5
CONF_TOL = 1e-4
CLIPH_READERS = ("detect_ms.cliph", "detect_idle_ms.cliph",
                 "longterm_ms.cliph", "idle_share.cliph", "mfu.cliph")


def tiny_config() -> dict:
    """The cell's configuration cut for the CPU: the tiny store and
    encoder of ``navbench/tests/tiny.py`` and a CLIP of width 64, 2 layers
    a tower, 32^2 images in 4-pixel patches (an 8 x 8 grid), and a target
    of 12 boxes a frame: the tiny CLIP's 32-wide embeddings already draw
    8 a frame with no structured term, 11.6 at the least scale searched."""
    c = tiny.config("habitat-dinov2l-cliph")
    c["detector"].update(
        embed_dim=32, image_size=32, patch_size=4, vision_width=64,
        vision_layers=2, vision_heads=2, vision_mlp=256, context_length=16,
        vocab_size=512, text_width=64, text_heads=2, text_layers=2,
        text_mlp=256, boxes_a_frame=12.0)
    c["check"].update(min_boxes=20, min_pairs_clear=0.9, min_instances=10)
    return c


@pytest.fixture(scope="module")
def model():
    """(configuration, reference weights, the port's CLIP, its config,
    the port's detector) at the tiny size."""
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models.detector import ClipPatchDetector
    from bsc_nav_tpu_torch.models.tokenizer import HashTokenizer
    c = tiny_config()
    d = c["detector"]
    w = WC.draw(d, 21, 22, "cpu", scale=8.0)
    ccfg = D.clip_config(d)
    cm = C.CLIP(ccfg, device="cpu")
    cm.load_state_dict(w, strict=True)
    det = ClipPatchDetector(
        cm, ccfg, HashTokenizer(vocab_size=d["vocab_size"],
                                context_length=d["context_length"]),
        d["classes"], d["confidence"], device="cpu")
    return c, w, cm, ccfg, det


@pytest.fixture(scope="module")
def frames():
    c, t = tiny_config(), tiny.traffic("room-patrol-cliph")
    s = c["sensor"]
    from navbench import scene
    poses = scene.bank_poses(t)
    rgb, depth = scene.render(poses[:8], t, 5, s["height"], s["width"],
                              s["hfov_deg"], s["sensor_height"], "cpu")
    return rgb, depth, poses[:8]


def test_text_tower_and_tokenizer(model):
    from bsc_nav_tpu_torch.models import tokenizer as T
    c, w, _, _, det = model
    d = c["detector"]
    prompts = M.class_prompts(d)
    ids = T.tokenize(prompts, T.HashTokenizer(
        vocab_size=d["vocab_size"], context_length=d["context_length"]))
    np.testing.assert_array_equal(
        M.tokenize(prompts, d["vocab_size"], d["context_length"]), ids)
    np.testing.assert_allclose(det.text_emb,
                               M.text_embeddings(w, d, prompts).numpy(),
                               atol=EMBED_TOL, rtol=0)


def test_dense_embed_against_reference(model, frames):
    c, w, _, _, det = model
    rgb = frames[0]
    got = det.embed(rgb)
    want = M.patch_embeddings(w, c["detector"], torch.from_numpy(rgb))
    assert got.shape == tuple(want.shape) == (8, 64, 32)
    gap = np.linalg.norm(got - want.numpy(), axis=-1).max()
    assert gap <= EMBED_TOL, gap


@pytest.mark.parametrize("act", ["tanh", "gelu_exact"])
def test_wrong_gelu_fails_embed_gap(model, frames, act):
    """The detector's path with the tanh or the erf GELU in place of the
    published quick GELU lies beyond the cell's ``embed_gap`` limit."""
    from bsc_nav_tpu_torch.models.detector import dense_embed
    c, w, cm, ccfg, _ = model
    rgb = torch.from_numpy(frames[0])
    wrong = dataclasses.replace(ccfg, quick_gelu=False,
                                gelu_exact=act == "gelu_exact")
    got = dense_embed(cm, rgb, wrong).numpy()
    want = M.patch_embeddings(w, c["detector"], rgb).numpy()
    assert np.linalg.norm(got - want, axis=-1).max() > \
        c["limits"]["embed_gap"]


def test_detect_batch_against_reference(model, frames):
    """Boxes equal and confidences within CONF_TOL over every clear
    (frame, class) pair; each frame's boxes in the reference's order."""
    c, w, _, _, det = model
    d, s = c["detector"], c["sensor"]
    rgb = frames[0]
    got = det.detect_batch(rgb)
    emb = M.patch_embeddings(w, d, torch.from_numpy(rgb)).numpy()
    text = M.text_embeddings(w, d, M.class_prompts(d)).numpy()
    compared = n_boxes = 0
    for v in range(len(rgb)):
        want = M.boxes(emb[v], text, d, s["height"], s["width"])
        unclear = D.unclear_classes(emb[v], text, d, CONF_TOL)
        for ci, name in enumerate(d["classes"]):
            if ci in unclear:
                continue
            compared += 1
            p = [(x.xyxy, x.confidence) for x in got[v] if x.label == name]
            r = [(b, cf) for lab, cf, b in want if lab == name]
            n_boxes += len(r)
            assert [b for b, _ in p] == [b for b, _ in r]
            np.testing.assert_allclose([cf for _, cf in p],
                                       [cf for _, cf in r], atol=CONF_TOL)
    assert compared >= 0.9 * len(rgb) * len(d["classes"]) and n_boxes > 20


def test_longterm_feed_against_reference(model, frames):
    """Eight frames through ``VoxelTokenMemory`` with the detector: the
    long-term memory equals the reference's located and integrated
    instances, by (label, voxel), with confidences within CONF_TOL.  The
    synthetic room's walls lie on voxel faces, so a centre there may fall
    on either side in the program's float32 geometry: the reference's
    instance then pairs with the program's at any voxel it could be, and
    a merge that another of them would decide otherwise is left out
    (``metaclip.Unsure``)."""
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import vit
    c, w, _, _, det = model
    d = c["detector"]
    rgb, depth, poses = frames
    cfg = MB.program_config(c, 0, False)
    perception = Perception.create(
        cfg, vit_cfg=vit.ViTConfig(img_size=28, patch_size=14, dim=32,
                                   depth=1, heads=2, num_registers=0),
        batch_size=4, device="cpu")
    mem = VoxelTokenMemory(cfg, None, perception, detector=det)
    for i in range(8):
        mem.push_frame({"rgb": rgb[i], "depth": depth[i]}, poses[i])
    emb = M.patch_embeddings(w, d, torch.from_numpy(rgb)).numpy()
    text = M.text_embeddings(w, d, M.class_prompts(d)).numpy()
    s, m = c["sensor"], c["memory"]
    want, unsure = [], M.Unsure(d["dedup_l1"])
    for f in range(2):
        dets = [M.boxes(emb[v], text, d, s["height"], s["width"])
                for v in range(4 * f, 4 * f + 4)]
        want.extend(x for v, dv in zip(range(4 * f, 4 * f + 4), dets)
                    for x in M.locate(dv, depth[v], poses[v], poses[0], s, m,
                                      c["check"]["edge_m"]))
        if any(dets):
            want = M.integrate(want, d["dedup_l1"], D.conf_err(c), unsure)
    info = {}
    cc = copy.deepcopy(c)
    cc["check"]["score_tol"] = CONF_TOL
    got = D.compare_instances(cc, mem.long_memory_dict, want, info, unsure)
    assert info["instances_compared"] >= 10
    assert sum(len(x["cands"]) > 1 for x in want) >= 1
    assert got.value == 0.0 and info["instances_one_side"] == 0


# ---------------------------------------------------------------------------
# a tiny traced run of the cell's driver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cell_run():
    """A traced run whose traced part starts at its second flush
    (``torch_worlds.split_traced_run``), and what its detector check was
    handed."""
    seen = {}
    real = D.check_detector

    def spy(ctx, c, ref, walk, kept, instances, n_flushes, info):
        seen.update(c=c, ref=ref, walk=walk, kept=kept, instances=instances,
                    n_flushes=n_flushes)
        return real(ctx, c, ref, walk, kept, instances, n_flushes, info)

    def once(seconds, traffic_update):
        ctx = tiny.ctx(seconds=seconds, seed=2 ** 31 + 26, trace=True,
                       config=tiny_config(), traffic=dict(
                           tiny.traffic("room-patrol-cliph"),
                           **traffic_update))
        ctx.cell = {"name": "build.cliph-b8", "chips": 1}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(D, "check_detector", spy)
            return D.run(ctx), ctx, seen

    return split_traced_run(once)


def test_tiny_cell_run_is_correct(cell_run):
    out, _, seen = cell_run
    assert out.correct, out.checks
    assert [ch.name for ch in out.checks] == [
        "rows_off", "voxels_off", "embed_gap", "boxes_off", "instances_off"]
    i = out.info
    assert i["embed_batches_compared"] == len(seen["kept"].emb) >= 1
    assert i["boxes_compared"] >= 20 and i["instances_reference"] >= 10
    assert out.traced_items > 0
    cnt = i["window_counters"]
    assert cnt["detector.frames"] == 8 * i["window_flushes"]


def test_seeds_keep_the_store_side():
    """The CLIP's seeds are new; the store's are ``memory_build``'s, so
    the two cells build the same store from one seed."""
    a = D.seeds(2 ** 31 + 99)
    b = MB.seeds(2 ** 31 + 99)
    assert {k: a[k] for k in b} == b
    assert len({a["clip"], a["clip_dirs"], *b.values()}) == 5


@pytest.fixture(scope="module")
def reference(cell_run):
    _, _, seen = cell_run
    c = seen["c"]
    d, s = c["detector"], c["sensor"]
    text, emb = seen["ref"].text.numpy(), seen["ref"].embeddings(8, "cpu")
    dets = [M.boxes(emb[v], text, d, s["height"], s["width"])
            for v in range(len(emb))]
    unclear = [D.unclear_classes(emb[v], text, d, c["check"]["heat_margin"])
               for v in range(len(emb))]
    return dets, unclear


def test_boxes_shifted_one_patch_fail(cell_run, reference):
    _, _, seen = cell_run
    c = seen["c"]
    dets, unclear = reference
    sound = D.compare_boxes(c, seen["kept"].dets, dets, unclear, {})
    assert sound.ok and sound.value == 0.0
    step = c["sensor"]["width"] / (c["detector"]["image_size"]
                                   // c["detector"]["patch_size"])
    shifted = {j: [[dataclasses.replace(x, xyxy=(x.xyxy[0] + step, x.xyxy[1],
                                                 x.xyxy[2] + step, x.xyxy[3]))
                    for x in frame] for frame in out]
               for j, out in seen["kept"].dets.items()}
    bad = D.compare_boxes(c, shifted, dets, unclear, {})
    assert not bad.ok and bad.value > 0.1, bad


def test_half_the_instances_dropped_fail(cell_run, reference):
    _, _, seen = cell_run
    c = seen["c"]
    dets, unclear = reference
    want, unsure = D.replay_instances(c, seen["walk"], dets, unclear,
                                      seen["n_flushes"], {})
    got = seen["instances"]
    assert D.compare_instances(c, got, want, {}, unsure).value == 0.0
    bad = D.compare_instances(c, got[::2], want, {}, unsure)
    assert not bad.ok and bad.value > 0.4, bad


def test_checks_over_too_little_are_not_correct(cell_run, reference):
    _, _, seen = cell_run
    c = copy.deepcopy(seen["c"])
    dets, unclear = reference
    c["check"].update(min_boxes=10 ** 6, min_instances=10 ** 6)
    assert D.compare_boxes(c, seen["kept"].dets, dets, unclear,
                           {}).value == 1.0
    assert D.compare_instances(c, seen["instances"], seen["instances"],
                               {}).value == 1.0


@pytest.mark.parametrize("name", CLIPH_READERS)
def test_cliph_reader_gives_a_finite_number(cell_run, name):
    out, ctx, _ = cell_run
    v = R.metric_reader(name)(out, ctx)
    assert v is not None and math.isfinite(v) and v >= 0


def test_cliph_readers_report_nothing_without_detector_spans(cell_run,
                                                             monkeypatch):
    """A program that records no detector spans (the parent of this
    cell's program) gives no number, and no reader raises."""
    from navbench.metrics import _program_spans as PS
    out, ctx, _ = cell_run
    recs = [r for r in PS.records()
            if not r.name.startswith(("detector.", "longterm."))]
    monkeypatch.setattr(PS, "records", lambda: recs)
    for name in ("detect_ms.cliph", "detect_idle_ms.cliph",
                 "longterm_ms.cliph"):
        assert R.metric_reader(name)(out, ctx) is None, name
    # the CPU's trace holds no device kernel: no K3 time to read
    assert R.metric_reader("k3_roofline.cliph")(out, ctx) is None


def test_k3_roofline_reads_k3_alone():
    import importlib.util
    from navbench.harness import Outcome, Spans, Trace
    spec = importlib.util.spec_from_file_location(
        "k3", R.PKG / "metrics" / "k3_roofline.cliph.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.is_k3("void attention_tf32_kernel<short_attention, 80, "
                     "tc::Contiguous>(tc::Contiguous, int, int)")
    assert not mod.is_k3("void attention_tf32_kernel<short_attention_qkv, "
                         "64, tc::FusedQKV>(tc::FusedQKV, int, int)")
    assert not mod.is_k3("void attention_wgmma_kernel<short_attention>()")
    c = tiny_config()
    tr = Trace(kernels=[("attention_tf32_kernel<short_attention, 16>",
                         0.0, 0.5), ("sgemm", 0.5, 1.0)],
               spans=[], lo=0.0, hi=1.0)
    out = Outcome(e2e={}, attempted=1, failed=0, checks=[], device={},
                  spans=Spans(), trace=tr, traced_items=2)
    ctx = tiny.ctx(config=c)
    assert mod.read(out, ctx) == pytest.approx(
        100 * 2 * CS.k3_calls(c) * CS.k3_call_s(c) / 0.5)


def test_detector_least_time_by_hand():
    """MetaCLIP ViT-H/14 at B 8: 31 blocks of 24 W^2 operations a token
    over 8 x 257 tokens (80.8 GFLOP a block), the last block's v and
    out-projection, the patch embedding and the 256 patches' projection
    at 165 TFLOP/s in f32, and 31 attention calls at K3's bound."""
    c = R.load_json(R.ROOT / "navbench" / "configs"
                    / "habitat-dinov2l-cliph.json")
    T, Wd = 8 * 257, 1280
    assert 24 * T * Wd * Wd == pytest.approx(80.8e9, rel=1e-3)
    flops = (31 * 24 * T * Wd * Wd + 2 * 2 * T * Wd * Wd
             + 2 * 8 * 256 * 588 * Wd + 2 * 8 * 256 * Wd * 1024)
    k3 = max(4 * 8 * 16 * 257 * 257 * 80 / 165e12,
             4 * 8 * 16 * 80 * 4 * 257 / 3.35e12)
    assert CS.k3_call_s(c) == pytest.approx(k3)
    assert CS.detector_least_s(c) == pytest.approx(flops / 165e12 + 31 * k3)
    assert CS.flush_least_s(c) == pytest.approx(
        CS.detector_least_s(c) + BS.flush_least_s(c))


def test_instances_shifted_one_voxel_fail(cell_run, reference):
    """The planted fault the driver also reads at the cell's size: the
    program's instances moved by one voxel fail ``instances_off``."""
    out, _, seen = cell_run
    c = seen["c"]
    dets, unclear = reference
    want, unsure = D.replay_instances(c, seen["walk"], dets, unclear,
                                      seen["n_flushes"], {})
    bad = D.compare_instances(c, D.shifted(seen["instances"]), want, {},
                              unsure)
    assert not bad.ok and bad.value > 0.4, bad
    assert out.info["instances_off_shifted"] == bad.value


def test_calibrated_scale_meets_the_target(cell_run, reference):
    """The structured term's scale puts the reference's boxes a frame over
    the patrol's views at the configuration's target (and less than one
    box a frame above it), with a box in its share of the frames, as
    ``metaclip.boxes`` counts them."""
    out, _, seen = cell_run
    d, ref = seen["c"]["detector"], seen["ref"]
    dets, _ = reference
    n = np.array([len(x) for x in dets])
    got = WC.box_counts(ref.tokens, ref.proj, ref.text, d)
    assert np.abs(got - n).mean() <= 0.05
    assert d["boxes_a_frame"] <= n.mean() < d["boxes_a_frame"] + 1
    assert (n > 0).mean() >= d["frames_with_box"]
    assert WC.SCALE_RANGE[0] < ref.scale < WC.SCALE_RANGE[1]
    assert out.info["class_term_scale"] == ref.scale
    assert out.info["clip_draw"] == ref.draw == 0


def test_a_load_out_of_reach_draws_the_clip_again(cell_run):
    """A target no scale reaches: every one of the draws is tried, each
    from its own seeds (the first the run's ``seeds``), and the last
    keeps the range's top scale."""
    _, _, seen = cell_run
    c = seen["c"]
    d = dict(c["detector"], boxes_a_frame=10 ** 6)
    rgb = seen["walk"].rgb[:8]
    _, ref = D.draw_clip(d, 2 ** 31 + 26, rgb, 8, "cpu")
    assert ref.draw == D.CLIP_DRAWS - 1
    assert ref.scale == WC.SCALE_RANGE[1]
    sd = D.seeds(2 ** 31 + 26)
    assert D.clip_seeds(2 ** 31 + 26) == {"clip": sd["clip"],
                                          "clip_dirs": sd["clip_dirs"]}
    drawn = [tuple(D.clip_seeds(2 ** 31 + 26, k).values())
             for k in range(D.CLIP_DRAWS)]
    assert len(set(drawn)) == D.CLIP_DRAWS
