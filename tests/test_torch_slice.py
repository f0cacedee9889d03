"""Port parity for the whole memory spine: frames -> ViT -> ingest ->
store -> query -> top-K, against bsc_nav_tpu/memory/pipeline.py on the
fake environment, plus the agent surface (Perception, VoxelTokenMemory).
"""

import math
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.env.fake import BoxScene, FakeNavEnv
from bsc_nav_tpu.env.pathfinding import AgentState, Quat
from bsc_nav_tpu.memory import pipeline as jpipe
from bsc_nav_tpu.memory.store import init_store as jinit
from bsc_nav_tpu.models import vit as jv
from bsc_nav_tpu_torch.agents.spatial_memory import (
    Perception, VoxelTokenMemory)
from bsc_nav_tpu_torch.memory import pipeline as tpipe
from bsc_nav_tpu_torch.memory.store import init_store as tinit
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models.weights import vit_from_jax_params

from bsc_nav_tpu_torch import geometry as TG
from torch_parity import (
    assert_frame_points_within_bound, assert_same_topk, build_step_draws,
    store_fields_equal)

TG_camera_to_world = TG.camera_to_world_transform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_KW = dict(img_size=56, patch_size=14, dim=32, depth=2, heads=2,
              num_registers=1)


def _cfg():
    """tests/test_end_to_end_memory.py's config: 96^2 grid, 4x4 patches."""
    cfg = small_test_config()
    return cfg.replace(
        memory=cfg.memory.__class__(
            grid_size=96, floor_height=-3.2, map_height=3.2, token_dim=32,
            cache_size=4, voxel_capacity=(1 << 13) - 8, depth_sample_rate=4),
        query=cfg.query.__class__(top_k=16, query_width=56,
                                  query_height=56))


@pytest.fixture(scope="module")
def world():
    """12 frames spinning in place, and a close-up query of the red box."""
    cfg = _cfg()
    scene = BoxScene.default()
    env = FakeNavEnv(cfg, scene=scene, seed=3)
    env.reset(init_state=AgentState(np.zeros(3), Quat.from_yaw(0.0)),
              build_map=True)
    frames = []
    obs = env.sims.get_sensor_observations(0)
    for _ in range(12):
        frames.append((obs["rgb"][:, :, :3].copy(), obs["depth"].copy(),
                       env.agent_pose_vec()))
        obs = env.step("turn_left")
    rgb, depth, poses = (np.stack([f[i] for f in frames]) for i in range(3))

    box = scene.boxes[0]
    c = np.asarray(box.center)
    look_from = c + np.array([-0.8, -c[1], -0.8])
    yaw = math.atan2(-(c[0] - look_from[0]), -(c[2] - look_from[2]))
    env.agent.set_state(AgentState(look_from, Quat.from_yaw(yaw)))
    for _ in range(3):
        env.step("look_down")
    qimg = env.sims.get_sensor_observations(0)["rgb"][None, :, :, :3].copy()
    params = jax.tree_util.tree_map(
        np.asarray, jv.init_params(jv.ViTConfig(**VIT_KW),
                                   jax.random.PRNGKey(0)))
    return cfg, env, frames, (rgb, depth, poses), qimg, params


def _torch_slice(cfg, params, batch, qimg, draws, device, points=None):
    rgb, depth, poses = batch
    model = vit_from_jax_params(params, tv.ViTConfig(**VIT_KW),
                                device=device)
    build = tpipe.make_build_step(cfg, model.cfg)
    query = tpipe.make_query_step(cfg, model.cfg)
    pix, repl = (torch.from_numpy(a).to(device) for a in draws)
    if points is not None:
        points = [torch.from_numpy(a).to(device) for a in points]
    (state, _), _ = build(
        (tinit(cfg.memory, device=device), None), model,
        *(torch.from_numpy(a).to(device) for a in (rgb, depth, poses)),
        pix=pix, repl_idx=repl, points=points)
    pos, sc = query(state, model, torch.from_numpy(qimg).to(device),
                    top_k=16)
    return state, pos.cpu().numpy(), sc.cpu().numpy()


def _jax_slice(cfg, params, batch, qimg):
    jcfg = jv.ViTConfig(**VIT_KW)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    carry = (jinit(cfg.memory), jax.random.PRNGKey(7))
    carry, _ = jpipe.make_build_step(cfg, jcfg)(
        carry, jparams, *map(jnp.asarray, batch))
    pos, sc = jpipe.make_query_step(cfg, jcfg)(carry[0], jparams,
                                               jnp.asarray(qimg), top_k=16)
    return carry[0], np.asarray(pos), np.asarray(sc)


def _check_slice(world):
    cfg, _, _, batch, qimg, params = world
    _, pix, repl = build_step_draws(jax.random.PRNGKey(7), cfg, 12)
    points = assert_frame_points_within_bound(cfg, batch[1], batch[2], pix)
    js, jpos, jsc = _jax_slice(cfg, params, batch, qimg)
    ts, tpos, tsc = _torch_slice(cfg, params, batch, qimg, (pix, repl),
                                 "cpu", points=points[1:])
    assert int(ts.num_voxels) > 200
    store_fields_equal(js, ts, cfg)
    VK = cfg.memory.voxel_capacity * cfg.memory.cache_size
    np.testing.assert_allclose(ts.feats[:VK].numpy(),
                               np.asarray(js.feats)[:VK], atol=1e-4)
    assert np.isfinite(jsc).all()
    assert_same_topk(tpos, tsc, jpos, jsc, atol=1e-4)


def test_build_and_query_match_jax(world):
    """Same frames, same weights, JAX draws injected.  The port's float
    geometry (cam2world, camera and world points) is held to JAX's within
    the ulp bounds of ``torch_parity.assert_frame_points_within_bound``,
    not bit for bit: XLA's jitted 3-term products are FMA chains on some
    host codegens and plain sums on others, and this world's axis-aligned
    walls put points on cell edges.  JAX's points are then injected, and
    everything downstream is compared: the ViT's f32 tokens differ by
    ~1e-6, so stored rows are compared within 1e-4 and the top-K scores
    within 1e-4; the integer store and the top-K voxel set (up to ties at
    the K-th score) must be equal."""
    _check_slice(world)


def _floor_world_to_grid(points, grid_size, cell_size):
    # the fault: floor where the reference truncates toward zero
    half = grid_size // 2
    ids = torch.floor(points * np.float32(1.0 / cell_size)).to(torch.int32)
    return torch.stack([half - ids[..., 0], half - ids[..., 1],
                        ids[..., 2]], dim=-1)


def _transposed_cam2world(*args):
    tf = TG_camera_to_world(*args).clone()
    tf[..., :3, :3] = tf[..., :3, :3].transpose(-1, -2)
    return tf


@pytest.mark.parametrize("fault", ["floor_in_world_to_grid",
                                   "transposed_rotation"])
def test_slice_check_catches_a_fault(world, monkeypatch, fault):
    """The restated check still fails a real fault: voxel ids by floor
    instead of truncation (downstream of the injected points, caught by
    the exact store), or the world rotation transposed (caught by the
    float geometry's bound)."""
    if fault == "floor_in_world_to_grid":
        monkeypatch.setattr(TG, "world_to_grid", _floor_world_to_grid)
    else:
        monkeypatch.setattr(TG, "camera_to_world_transform",
                            _transposed_cam2world)
    with pytest.raises(AssertionError):
        _check_slice(world)


def _grid_to_world(cfg, origin, rc):
    row, col, h = rc
    x = origin[0] + (col - cfg.memory.grid_size // 2) * cfg.memory.cell_size
    z = origin[2] + (row - cfg.memory.grid_size // 2) * cfg.memory.cell_size
    return np.array([x, (h + cfg.memory.zmin) * cfg.memory.cell_size, z])


def test_voxel_token_memory_finds_the_box(world):
    """The agent surface end to end (as tests/test_end_to_end_memory.py
    does for JAX): push frames, flush a short batch, localize an image of
    the red box; most of the top-K lies within 2 m of it."""
    cfg, env, frames, _, qimg, params = world
    perception = Perception.create(
        cfg, vit_cfg=tv.ViTConfig(**VIT_KW), batch_size=5,
        vit_params=vit_from_jax_params(params, tv.ViTConfig(**VIT_KW),
                                       device="cpu"), device="cpu")
    mem = VoxelTokenMemory(cfg, env=env, perception=perception)
    for rgb, depth, pose in frames:
        mem.push_frame({"rgb": rgb, "depth": depth}, pose)
    mem.flush()                         # 12 = 5 + 5 + a padded 2
    assert int(mem.state.num_voxels) > 200
    best, pos, sims = mem.voxel_localized(qimg[0], K=16)
    assert pos.shape == (16, 3) and np.all(np.diff(sims) <= 0)
    c = np.asarray(BoxScene.default().boxes[0].center)
    origin = np.asarray(env.original_state.position)
    world_pos = np.stack([_grid_to_world(cfg, origin, p) for p in pos])
    d = np.linalg.norm(world_pos[:, [0, 2]] - c[None, [0, 2]], axis=1)
    assert (d < 2.0).mean() >= 0.5, d
    region = mem.voxel_localized(qimg[0], K=16, region_radius=5.0,
                                 curr_grid=pos[0])[1]
    assert len(region) and np.all(
        ((region - pos[0]) ** 2).sum(axis=1) <= 25)
    # a text prompt needs an imagination (tests/test_torch_textq.py)
    with pytest.raises(RuntimeError, match="imagination"):
        mem.voxel_localized("a red bed")


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np\n"
        "from bsc_nav_tpu_torch.config import small_test_config\n"
        "from bsc_nav_tpu_torch.agents.spatial_memory import "
        "Perception, VoxelTokenMemory\n"
        "from bsc_nav_tpu_torch.models import vit\n"
        "cfg = small_test_config()\n"
        "vc = vit.ViTConfig(img_size=28, dim=32, depth=1, heads=2)\n"
        "m = VoxelTokenMemory(cfg, None, Perception.create(cfg, vc, "
        "batch_size=2, device='cpu'))\n"
        "rng = np.random.default_rng(0)\n"
        "for i in range(3):\n"
        "    m.push_frame({'rgb': rng.integers(0, 255, (64, 64, 3), "
        "np.uint8), 'depth': rng.uniform(0.5, 3, (64, 64)).astype("
        "np.float32)}, np.array([0, 0, 0, 0, 0, 0, 1], np.float32))\n"
        "m.voxel_localized(rng.integers(0, 255, (28, 28, 3), np.uint8))\n"
        "assert int(m.state.num_voxels) > 0\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = small_test_config()
    with pytest.raises(RuntimeError, match="cuda"):
        Perception.create(cfg, tv.ViTConfig(img_size=28, dim=32, depth=1,
                                            heads=2), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tinit(cfg.memory, device="cuda")
