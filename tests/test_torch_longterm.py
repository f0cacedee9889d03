"""Port parity for the long-term memory: detections -> located instances
(bsc_nav_tpu/memory/longterm.py) and the detector feed of
``VoxelTokenMemory`` (agents/spatial_memory.py), inline (a host detector)
and once per flush (``ClipPatchDetector.detect_batch``)."""

import types
from collections import Counter

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bsc_nav_tpu.agents import spatial_memory as jsm
from bsc_nav_tpu.config import HM3D_DETECT_CLASSES, small_test_config
from bsc_nav_tpu.env.fake import BoxScene, FakeNavEnv
from bsc_nav_tpu.env.pathfinding import AgentState, Quat
from bsc_nav_tpu.memory import longterm as JLT
from bsc_nav_tpu.models import clip as JC
from bsc_nav_tpu.models.detector import ClipPatchDetector as JDetector
from bsc_nav_tpu.models.detector import ColorPrototypeDetector, Detection
from bsc_nav_tpu.models.tokenizer import HashTokenizer
from bsc_nav_tpu_torch.agents import spatial_memory as tsm
from bsc_nav_tpu_torch.memory import longterm as TLT
from bsc_nav_tpu_torch.models import clip as TC
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models.detector import ClipPatchDetector
from bsc_nav_tpu_torch.models.weights import clip_from_jax_params

PROTOTYPES = {"bed": (200, 30, 30), "plant": (30, 180, 40),
              "sofa": (40, 60, 220), "tv monitor": (230, 220, 40),
              "table": (150, 90, 40)}
HD80 = dict(embed_dim=32, image_size=56, patch_size=14, vision_width=160,
            vision_layers=2, vision_heads=2, context_length=16,
            vocab_size=512, text_width=128, text_heads=2, text_layers=2)


def _random_detections(rng, n, H, W):
    out = []
    for i in range(n):
        x1, y1 = rng.uniform(-10, W), rng.uniform(-10, H)
        out.append(Detection(HM3D_DETECT_CLASSES[i % 4], float(rng.uniform()),
                             (x1, y1, x1 + rng.uniform(1, 30),
                              y1 + rng.uniform(1, 30))))
    return out


def _cam_tf(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    x, y, z, w = q
    tf = np.eye(4)
    tf[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)],
                  [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)],
                  [2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)]]
    tf[:3, 3] = rng.uniform(-2, 2, size=3)
    return tf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instances_from_detections_matches_jax(seed):
    """Host numpy on both sides: equal instance lists (boxes off the frame
    and depths outside the sensor range are dropped alike)."""
    cfg = small_test_config()
    rng = np.random.default_rng(seed)
    H = W = cfg.sensor.height
    depth = rng.uniform(0.0, 6.0, size=(H, W)).astype(np.float32)
    dets = _random_detections(rng, 40, H, W)
    tf = _cam_tf(rng)
    want = JLT.instances_from_detections(dets, depth, tf, cfg)
    got = TLT.instances_from_detections(dets, depth, tf, cfg)
    assert got == want and len(want) > 5


@pytest.mark.parametrize("threshold", [1, 3, 6])
def test_integrate_and_floor_filter_match_jax(threshold):
    rng = np.random.default_rng(threshold)
    centers = rng.integers(0, 60, size=(6, 3))
    items = [{"label": HM3D_DETECT_CLASSES[int(rng.integers(3))],
              "loc": (centers[int(rng.integers(6))]
                      + rng.integers(-2, 3, size=3)).tolist(),
              "confidence": float(rng.uniform())} for _ in range(80)]
    want = JLT.integrate(items, threshold)
    got = TLT.integrate(items, threshold)
    assert got == want and len(want) < len(items)
    assert (TLT.filter_by_floor(got, 10, 40)
            == JLT.filter_by_floor(want, 10, 40))


@pytest.fixture(scope="module")
def spin():
    """12 frames turning in place in the fake box world."""
    cfg = small_test_config()
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


def _memories(cfg, env, detector_pair, batch):
    """The port's VoxelTokenMemory (a tiny ViT on its real build path) and
    the JAX package's, whose build step is stubbed out: only the long-term
    feed is compared."""
    vcfg = tv.ViTConfig(img_size=28, patch_size=14, dim=32, depth=1,
                        heads=2, num_registers=1)
    perception = tsm.Perception.create(cfg, vcfg, batch_size=batch,
                                       device="cpu")
    stub = types.SimpleNamespace(batch_size=batch, vit_params=None,
                                 build_step=lambda carry, *a: (carry, None))
    return (tsm.VoxelTokenMemory(cfg, env, perception,
                                 detector=detector_pair[0]),
            jsm.VoxelTokenMemory(cfg, env, stub, detector=detector_pair[1]))


def _same_instances(got, want, conf_atol):
    def key(o):
        return o["label"], tuple(o["loc"])
    assert Counter(map(key, got)) == Counter(map(key, want))
    g = sorted(got, key=key)
    w = sorted(want, key=key)
    np.testing.assert_allclose([o["confidence"] for o in g],
                               [o["confidence"] for o in w], atol=conf_atol)


def test_inline_detector_feed_matches_jax(spin):
    """A host detector runs per pushed frame; equal long-term instances
    (as a multiset), also after a standalone ``long_memory`` pass and the
    floor filter."""
    cfg, env, frames = spin
    det = ColorPrototypeDetector(PROTOTYPES, confidence=0.5)
    tmem, jmem = _memories(cfg, env, (det, det), batch=5)
    for obs, pose in frames:
        tmem.push_frame(obs, pose)
        jmem.push_frame(obs, pose)
    tmem.flush()
    jmem.flush()
    assert int(tmem.state.num_voxels) > 0 and len(jmem.long_memory_dict) > 3
    _same_instances(tmem.long_memory_dict, jmem.long_memory_dict, 0.0)
    obs = env.sims.get_sensor_observations(0)
    tmem.long_memory(obs)
    jmem.long_memory(obs)
    _same_instances(tmem.long_memory_dict, jmem.long_memory_dict, 0.0)
    for m in (tmem, jmem):
        m.load_single_floor, m.floor_min_height, m.floor_max_height = \
            True, 20, 40
    _same_instances(tmem.long_memory_filter(), jmem.long_memory_filter(), 0.0)


def test_clip_patch_detector_feed_matches_jax(spin):
    """``ClipPatchDetector.detect_batch`` once per flush (4 + 4 + 4 frames)
    on the tiny hd-80 CLIP: equal long-term instances, confidences within
    1e-4 (the x100 softmax turns 1e-6 in a cosine into 1e-4 in a heat
    value), given no patch's heat within 1e-4 of the threshold and no
    near-tie between its two best classes."""
    cfg, env, frames = spin
    jcfg, tcfg = JC.CLIPConfig(**HD80), TC.CLIPConfig(**HD80)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(JC.init_params, static_argnums=0)(
            jcfg, jax.random.PRNGKey(1)))
    tok = HashTokenizer(vocab_size=512, context_length=16)
    classes, conf = list(HM3D_DETECT_CLASSES), 0.55
    jdet = JDetector(jax.tree_util.tree_map(jnp.asarray, params), jcfg, tok,
                     classes, conf)
    tdet = ClipPatchDetector(
        clip_from_jax_params(params, tcfg, device="cpu"), tcfg, tok,
                             classes, conf)

    rgbs = np.stack([obs["rgb"][:, :, :3] for obs, _ in frames])
    sims = np.asarray(jdet._dense(jdet.params, jnp.asarray(rgbs))) @ \
        jdet.text_emb.T * 100.0
    p = np.exp(sims - sims.max(axis=-1, keepdims=True))
    p = np.sort(p / p.sum(axis=-1, keepdims=True), axis=-1)
    assert np.abs(p[..., -1] - conf).min() > 1e-4
    assert (p[..., -1] - p[..., -2]).min() > 1e-4

    tmem, jmem = _memories(cfg, env, (tdet, jdet), batch=4)
    for obs, pose in frames:
        tmem.push_frame(obs, pose)
        jmem.push_frame(obs, pose)
    tmem.flush()
    jmem.flush()
    assert len(jmem.long_memory_dict) > 3
    _same_instances(tmem.long_memory_dict, jmem.long_memory_dict, 1e-4)

