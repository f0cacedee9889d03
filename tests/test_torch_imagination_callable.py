"""A plain-callable imagination in ``VoxelTokenMemory``'s text query,
against the JAX package (bsc_nav_tpu/agents/spatial_memory.py:375-380,
:424-437).

The JAX benchmarks and tests pass an imagination that is only a callable
(``SceneImagination`` in benchmarks/setup.py and
tests/test_objnav_episode.py): it has no ``imagine_core``, so the text
query skips the device path, renders the prompt's images on the host
through ``imaginary`` and runs the image query on them.  Both packages get
the same store (built by the JAX pipeline and copied), the same weights
and the same callable.
"""

import math
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bsc_nav_tpu.agents import spatial_memory as jsm
from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.env.fake import BoxScene, FakeNavEnv
from bsc_nav_tpu.env.pathfinding import AgentState, Quat
from bsc_nav_tpu.memory import pipeline as jpipe
from bsc_nav_tpu.memory.store import init_store as jinit
from bsc_nav_tpu.models import vit as jv
from bsc_nav_tpu_torch.agents import spatial_memory as tsm
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models.weights import vit_from_jax_params

from torch_parity import assert_same_topk, numpy_tree, store_from_jax

VIT_KW = dict(img_size=56, patch_size=14, dim=32, depth=2, heads=2,
              num_registers=1)
PROMPTS = ("a sofa", "the bed", "a chair")      # no box is a chair


class SceneCamera:
    """An imagination with only ``__call__``: three views of the scene box
    named in the prompt (the first box when none is), as the JAX tests'
    ``SceneImagination`` renders them."""

    def __init__(self, cfg, scene: BoxScene):
        self.scene = scene
        self.env = FakeNavEnv(cfg, scene=scene, seed=11)

    def __call__(self, text: str) -> np.ndarray:
        box = next((b for b in self.scene.boxes if b.label and re.search(
            rf"\b{re.escape(b.label)}\b", text)), self.scene.boxes[0])
        c = np.asarray(box.center)
        views = []
        for dx, dz in ((-0.8, -0.8), (-0.9, 0.0), (0.0, -0.9)):
            pos = c + np.array([dx, -c[1], dz])
            yaw = math.atan2(-(c[0] - pos[0]), -(c[2] - pos[2]))
            self.env.agent.set_state(AgentState(pos, Quat.from_yaw(yaw)))
            self.env.pitch = -math.radians(45)
            views.append(self.env.sims.get_sensor_observations(0)["rgb"]
                         [:, :, :3])
        return np.stack(views)


def _cfg():
    cfg = small_test_config()
    return cfg.replace(
        memory=cfg.memory.__class__(
            grid_size=96, floor_height=-3.2, map_height=3.2, token_dim=32,
            cache_size=4, voxel_capacity=(1 << 13) - 8, depth_sample_rate=4),
        query=cfg.query.__class__(top_k=16, query_width=56,
                                  query_height=56))


@pytest.fixture(scope="module")
def memories():
    """The JAX agent and the port's over one store of 12 frames turning in
    place in the fake box world, each with the same ``SceneCamera``."""
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
    batch = (np.stack([f[i] for f in frames]) for i in range(3))
    vcfg = jv.ViTConfig(**VIT_KW)
    params = jv.init_params(vcfg, jax.random.PRNGKey(0))
    (jstate, _), _ = jpipe.make_build_step(cfg, vcfg)(
        (jinit(cfg.memory), jax.random.PRNGKey(7)), params,
        *map(jnp.asarray, batch))
    assert int(jstate.num_voxels) > 200
    camera = SceneCamera(cfg, scene)

    jmem = jsm.VoxelTokenMemory(
        cfg, None, jsm.Perception.create(cfg, vcfg, vit_params=params),
        imagination=camera)
    jmem.state = jstate
    tvit = vit_from_jax_params(numpy_tree(params), tv.ViTConfig(**VIT_KW),
                               device="cpu")
    tmem = tsm.VoxelTokenMemory(
        cfg, None, tsm.Perception.create(cfg, tvit.cfg, vit_params=tvit,
                                         device="cpu"),
        imagination=camera)
    tmem.state = store_from_jax(jstate)
    return jmem, tmem, camera


@pytest.mark.parametrize("prompt", PROMPTS)
def test_plain_callable_text_query_matches_jax(memories, prompt):
    """``voxel_localized(prompt)`` renders the callable's images and runs
    the image query in both packages: the ViT's f32 tokens differ by
    ~1e-6, so scores agree within 1e-4 and the top-K voxel sets are equal
    up to ties at the K-th score; the port's result is its own image query
    on the rendered images."""
    jmem, tmem, camera = memories
    jbest, jpos, jsc = jmem.voxel_localized(prompt, K=16)
    tbest, tpos, tsc = tmem.voxel_localized(prompt, K=16)
    assert len(tpos) == len(jpos) == 16 and np.isfinite(jsc).all()
    assert_same_topk(jpos, jsc, tpos, tsc, atol=1e-4)
    _, ipos, isc = tmem.voxel_localized(camera(prompt), K=16)
    np.testing.assert_array_equal(ipos, tpos)
    np.testing.assert_array_equal(isc, tsc)
    np.testing.assert_array_equal(tbest, tpos[:1])


@pytest.mark.parametrize("prompt", ["a sofa", np.zeros((2, 8, 8, 3),
                                                       np.uint8)])
def test_async_text_query_refuses_a_plain_callable(memories, prompt):
    """No ``imagine_core``, or a prompt that is not text: no device text
    query to queue, so ``voxel_localized_async`` returns None in both."""
    jmem, tmem, _ = memories
    assert jmem.voxel_localized_async(prompt) is None
    assert tmem.voxel_localized_async(prompt) is None


def test_text_query_without_imagination_raises_in_both(memories):
    jmem, tmem, _ = memories
    for mem in (jmem, tmem):
        im, mem.imagination = mem.imagination, None
        try:
            assert mem.voxel_localized_async("a sofa") is None
            with pytest.raises(RuntimeError,
                               match="no imagination model configured"):
                mem.voxel_localized("a sofa")
        finally:
            mem.imagination = im
