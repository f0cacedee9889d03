"""Port parity: the device long-term feed -- ``instances_device``,
``instances_from_device`` and the device integration scan
(bsc_nav_tpu/memory/longterm.py), ``YoloWorldDetector.
detect_batch_instances`` (bsc_nav_tpu/models/yolo_world.py) and the
``detect_batch_instances`` branch of ``VoxelTokenMemory.flush``
(bsc_nav_tpu/agents/spatial_memory.py) -- against the JAX package on the
CPU, at YOLO_TEST with JAX-initialised params handed across.

The world points of ``instances_device`` are 3-term products whose last
bits jitted XLA forms as fused multiply-adds on some hosts only; the port
holds them to JAX's within a stated bound and compares grid ids given
JAX's points (``points=``), as tests/test_torch_slice.py does for the
ingest."""

import dataclasses
import types
from collections import Counter

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu import geometry as JG
from bsc_nav_tpu.agents import spatial_memory as jsm
from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.env.fake import BoxScene, FakeNavEnv
from bsc_nav_tpu.env.pathfinding import AgentState, Quat
from bsc_nav_tpu.memory import longterm as JLT
from bsc_nav_tpu.models import yolo_world as JY
from bsc_nav_tpu_torch.agents import spatial_memory as tsm
from bsc_nav_tpu_torch.config import small_test_config as t_small_config
from bsc_nav_tpu_torch.memory import longterm as TLT
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models import yolo_world as TY
from bsc_nav_tpu_torch.models.weights import yolo_world_from_jax_params
from torch_parity import _gamma, yolo_numpy_params

CLASSES = ["bed", "sofa", "chair", "plant", "table"]
TEXT_DIM = 32


def _cam_tfs(rng, B):
    """B random rigid camera -> world transforms (f32)."""
    out = np.tile(np.eye(4), (B, 1, 1))
    for b in range(B):
        q = rng.normal(size=4)
        x, y, z, w = q / np.linalg.norm(q)
        out[b, :3, :3] = [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
        out[b, :3, 3] = rng.uniform(-2, 2, size=3)
    return out.astype(np.float32)


@jax.jit
def _jax_points(boxes, depth, cam_tfs, inv_calib, det_size):
    """The float stage of JAX ``instances_device`` (``longterm.py:87-
    108``), jitted alone: (z, p_cam, p_world)."""
    B, H, W = depth.shape
    sx, sy = W / det_size, H / det_size
    x1 = jnp.clip(boxes[..., 0] * sx, 0, W)
    y1 = jnp.clip(boxes[..., 1] * sy, 0, H)
    x2 = jnp.clip(boxes[..., 2] * sx, 0, W)
    y2 = jnp.clip(boxes[..., 3] * sy, 0, H)
    rowc = jnp.clip(jnp.trunc((y1 + y2) / 2), 0, H - 1).astype(jnp.int32)
    colc = jnp.clip(jnp.trunc((x1 + x2) / 2), 0, W - 1).astype(jnp.int32)
    z = jnp.take_along_axis(depth.reshape(B, H * W), rowc * W + colc, 1)
    pix = jnp.stack([colc.astype(jnp.float32) + 0.5,
                     rowc.astype(jnp.float32) + 0.5, jnp.ones_like(z)], -1)
    p_cam = jnp.einsum("ij,bkj->bki", inv_calib, pix) * z[..., None]
    p_w = (jnp.einsum("bij,bkj->bki", cam_tfs[:, :3, :3], p_cam)
           + cam_tfs[:, None, :3, 3])
    return z, p_cam, p_w, pix


def jax_points(boxes, depth, cam_tfs, cfg, det_size):
    H, W = depth.shape[1:]
    inv = jnp.asarray(np.linalg.inv(JG.camera_intrinsics(
        H, W, cfg.sensor.hfov_deg)), jnp.float32)
    out = _jax_points(jnp.asarray(boxes), jnp.asarray(depth),
                      jnp.asarray(cam_tfs), inv, float(det_size))
    return [np.asarray(a, np.float64) for a in out] + [
        np.asarray(inv, np.float64)]


def assert_points_within_bound(boxes, depth, cam_tfs, cfg, det_size):
    """The port's camera and world points (``box_points``) against JAX's
    jitted ones: each a sum of 3 products (plus a translation) in f32, in
    any order, with or without FMA, within gamma_4 of the sum of the
    terms' magnitudes of the exact value; two evaluations within twice
    that, the world points also carrying the camera points' difference
    through |R|.  Returns JAX's world points (f32)."""
    z, pc, pw, pix, inv = jax_points(boxes, depth, cam_tfs, cfg, det_size)
    _, t_z, t_pc, t_pw = (a.numpy().astype(np.float64) if a.dtype != torch.bool
                          else a.numpy() for a in TLT.box_points(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (boxes, depth, cam_tfs)), cfg, det_size))
    np.testing.assert_array_equal(t_z, z)
    bound_c = 2 * _gamma(4) * (np.abs(pix) @ np.abs(inv).T) * np.abs(
        z)[..., None]
    d_c = np.abs(t_pc - pc)
    assert np.all(d_c <= bound_c), "p_cam outside its bound"
    R = np.asarray(cam_tfs, np.float64)[:, :3, :3]
    t = np.asarray(cam_tfs, np.float64)[:, None, :3, 3]
    bound_w = (2 * _gamma(4) * (np.abs(pc) @ np.abs(R).transpose(0, 2, 1)
                                + np.abs(t))
               + d_c @ np.abs(R).transpose(0, 2, 1))
    assert np.all(np.abs(t_pw - pw) <= bound_w), (
        f"p_world outside its bound by "
        f"{(np.abs(t_pw - pw) / bound_w).max():.2f}x")
    return pw.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instances_device_matches_jax(seed):
    """Random boxes (some off the frame), depths across the sensor range
    and rigid transforms: the float stage within its bound, then, given
    JAX's world points, equal grid ids, confidences, classes and ok
    masks, and equal instance dicts on the host."""
    cfg, tcfg = small_test_config(), t_small_config()
    rng = np.random.default_rng(seed)
    B, K, det = 3, 40, 64
    H = W = cfg.sensor.height
    xy = rng.uniform(-10, det + 5, size=(B, K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 30, size=(B, K, 2))],
                           -1).astype(np.float32)
    conf = rng.uniform(0.5, 1, size=(B, K)).astype(np.float32)
    cls = rng.integers(0, len(CLASSES), size=(B, K)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) > 0.2
    depth = rng.uniform(0.0, 6.0, size=(B, H, W)).astype(np.float32)
    tfs = _cam_tfs(rng, B)
    pw = assert_points_within_bound(boxes, depth, tfs, cfg, det)
    want = [np.asarray(a) for a in JLT.instances_device(
        *map(jnp.asarray, (boxes, conf, cls, valid, depth, tfs)), cfg, det)]
    got = [a.numpy() for a in TLT.instances_device(
        *map(torch.from_numpy, (boxes, conf, cls, valid, depth, tfs)), tcfg,
        det, points=torch.from_numpy(pw))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < want[3].sum() < want[3].size
    assert (TLT.instances_from_device(
        [torch.from_numpy(a) for a in got], CLASSES)
        == JLT.instances_from_device(want, CLASSES))


@pytest.mark.parametrize("threshold", [1, 3])
def test_integrate_device_scan_matches_jax_and_host(threshold):
    """Five batches of clustered detections: the port's scan state equals
    JAX's after every batch (integer ids, confidences copied, counts),
    and its keepers equal the host's cumulative ``integrate`` as a
    multiset."""
    rng = np.random.default_rng(threshold)
    B, K, cap = 2, 6, 48
    jscan = jax.jit(JLT.integrate_device_scan, static_argnames="threshold")
    jstate = JLT.integrate_state_init(cap)
    tstate = TLT.integrate_state_init(cap, device="cpu")
    host = []
    for _ in range(5):
        locs = rng.integers(0, 6, size=(B, K, 3)).astype(np.int32)
        conf = rng.random((B, K)).astype(np.float32)
        cls = rng.integers(0, 3, size=(B, K)).astype(np.int32)
        ok = rng.random((B, K)) > 0.3
        jstate = jscan(jstate, *map(jnp.asarray, (locs, conf, cls, ok)),
                       threshold=threshold)
        tstate = TLT.integrate_device_scan(
            tstate, *map(torch.from_numpy, (locs, conf, cls, ok)),
            threshold=threshold)
        for t, j in zip(tstate, jstate):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        host = TLT.integrate(host + [
            {"label": CLASSES[cls[b, k]], "loc": locs[b, k].tolist(),
             "confidence": float(conf[b, k])}
            for b in range(B) for k in range(K) if ok[b, k]], threshold)
        got = TLT.instances_from_integrate_state(tstate, CLASSES)
        key = lambda o: (o["label"], tuple(o["loc"]), o["confidence"])
        assert sorted(map(key, got)) == sorted(map(key, host))
    assert 0 < int(tstate[3]) < B * K * 5


@pytest.fixture(scope="module")
def detectors():
    params = yolo_numpy_params(JY.YOLO_TEST, 2, TEXT_DIM)
    text = np.random.default_rng(3).normal(size=(len(CLASSES), TEXT_DIM))
    kw = dict(classes=CLASSES, text_embeddings=text.astype(np.float32),
              confidence=0.6, iou_thr=0.5, decode_k=48, keep_k=16)
    return (TY.YoloWorldDetector(yolo_world_from_jax_params(
                params, TY.YOLO_TEST, device="cpu"), TY.YOLO_TEST, **kw),
            JY.YoloWorldDetector(jax.tree_util.tree_map(jnp.asarray, params),
                                 JY.YOLO_TEST, **kw))


def test_detect_batch_instances_matches_jax(detectors):
    """Frames of 80x72 (resized to 64^2), random depths and transforms:
    the candidates and NMS survivors equal JAX's (confidences distinct,
    within 1e-5), the world points within their bound, and given JAX's
    points the same instances (grid ids, labels, confidences within
    1e-5) as the JAX detector's one jitted dispatch."""
    tdet, jdet = detectors
    cfg, tcfg = small_test_config(), t_small_config()
    rng = np.random.default_rng(6)
    B, H, W = 3, 72, 80
    rgbs = rng.integers(0, 256, size=(B, H, W, 3), dtype=np.uint8)
    depths = rng.uniform(0.2, 1.5, size=(B, H, W)).astype(np.float32)
    tfs = _cam_tfs(rng, B)
    want = jdet.detect_batch_instances(rgbs, depths, tfs, cfg)
    assert len(want) > 3

    # the JAX detector's device path up to the NMS, and the port's
    x = jax.image.resize(jnp.asarray(rgbs, jnp.float32) / 255.0,
                         (B, 64, 64, 3), "bilinear")
    jb, jc, ji, jok = (np.asarray(a) for a in JY.nms_device(
        *JY.decode_topk_device(JY.forward(jdet.params, x, jdet.text_emb,
                                          jdet.cfg), jdet.cfg, k=48),
        iou_thr=0.5, conf_thr=0.6, k_out=16))
    xs = tdet._images(rgbs)
    tb, tc, ti, tok = (a.numpy() for a in TY.nms_device(
        *TY.decode_topk_device(TY.forward(tdet.params, xs, tdet.text_emb,
                                          tdet.cfg), tdet.cfg, k=48),
        iou_thr=0.5, conf_thr=0.6, k_out=16))
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(ti[tok], ji[jok])
    np.testing.assert_allclose(tc[tok], jc[jok], atol=1e-5, rtol=0)
    for c, n in zip(jc, jok.sum(1)):
        assert np.all(-np.diff(c[:n]) > 1e-5)
    pw = assert_points_within_bound(jb, depths, tfs, cfg, 64)
    got = TLT.instances_from_device(TLT.instances_device(
        *(torch.from_numpy(a) for a in (tb, tc, ti, tok, depths, tfs)),
        tcfg, 64, points=torch.from_numpy(pw)), CLASSES)
    assert [(o["label"], o["loc"]) for o in got] == [
        (o["label"], o["loc"]) for o in want]
    np.testing.assert_allclose([o["confidence"] for o in got],
                               [o["confidence"] for o in want], atol=1e-5)
    # the port's own entry point: with these generic transforms no world
    # point lies on a cell edge, so its own points give the same dicts
    own = tdet.detect_batch_instances(rgbs, depths, tfs, tcfg)
    assert [(o["label"], o["loc"]) for o in own] == [
        (o["label"], o["loc"]) for o in got]
    np.testing.assert_allclose([o["confidence"] for o in own],
                               [o["confidence"] for o in got], atol=0)


def wide_grid(cfg):
    """small_test_config with a 128-cell grid (12.8 m): the box world's far
    walls, where a random-weight detector's boxes center, lie 4 m out."""
    return dataclasses.replace(cfg, memory=dataclasses.replace(
        cfg.memory, grid_size=128))


@pytest.fixture(scope="module")
def spin():
    """12 frames turning in place in the fake box world."""
    cfg = wide_grid(small_test_config())
    env = FakeNavEnv(cfg, scene=BoxScene.default(), seed=3)
    env.reset(init_state=AgentState(np.zeros(3), Quat.from_yaw(0.0)),
              build_map=True)
    frames = []
    obs = env.sims.get_sensor_observations(0)
    for _ in range(12):
        frames.append(({"rgb": obs["rgb"], "depth": obs["depth"]},
                       env.agent_pose_vec()))
        obs = env.step("turn_left")
    return cfg, env, frames


def test_flush_with_yolo_matches_jax_agent(spin, detectors, monkeypatch):
    """``VoxelTokenMemory.flush`` with the YOLO detector (4 + 4 + 4 frames
    of the spin) against the JAX agent, whose build step is stubbed out:
    equal long-term instances as a multiset (labels, grid ids),
    confidences within 1e-5.  The box world's walls are axis-aligned, so
    box centers on them land exactly on cell edges (x = 4.0 m), where the
    grid id follows the last bit of the world point: each flush's world
    points are held to JAX's within their bound
    (``assert_points_within_bound``) and JAX's are injected, as the slice
    test injects its ingest points."""
    cfg, env, frames = spin
    tdet, jdet = detectors
    vcfg = tv.ViTConfig(img_size=28, patch_size=14, dim=32, depth=1,
                        heads=2, num_registers=1)
    tcfg = wide_grid(t_small_config())
    perception = tsm.Perception.create(tcfg, vcfg, batch_size=4,
                                       device="cpu")
    stub = types.SimpleNamespace(batch_size=4, vit_params=None,
                                 build_step=lambda carry, *a: (carry, None))
    tmem = tsm.VoxelTokenMemory(tcfg, env, perception, detector=tdet)
    jmem = jsm.VoxelTokenMemory(cfg, env, stub, detector=jdet)
    instances_device, flushes = TLT.instances_device, []

    def with_jax_points(boxes, conf, cls_idx, valid, depth, cam_tfs, mcfg,
                        det):
        pw = assert_points_within_bound(*(a.numpy() for a in (
            boxes, depth, cam_tfs)), cfg, det)
        flushes.append(int(valid.sum()))
        return instances_device(boxes, conf, cls_idx, valid, depth,
                                cam_tfs, mcfg, det,
                                points=torch.from_numpy(pw))

    monkeypatch.setattr(TLT, "instances_device", with_jax_points)
    for obs, pose in frames:
        tmem.push_frame(obs, pose)
        jmem.push_frame(obs, pose)
    tmem.flush()
    jmem.flush()
    assert len(flushes) == 3 and len(jmem.long_memory_dict) > 3
    key = lambda o: (o["label"], tuple(o["loc"]))
    got, want = tmem.long_memory_dict, jmem.long_memory_dict
    assert Counter(map(key, got)) == Counter(map(key, want))
    np.testing.assert_allclose(
        [o["confidence"] for o in sorted(got, key=key)],
        [o["confidence"] for o in sorted(want, key=key)], atol=1e-5)
