"""Port parity: the rest of ``VoxelTokenMemory`` -- ``excute`` and
``step_count``, the reference's aliases, ``exploring_create_memory``,
``explore_entire_space`` with ``_known_mask`` / ``_navigable_mask`` /
``_grid2loc_2d``, ``create_memory`` (bsc_nav_tpu/agents/
spatial_memory.py:156-166, :285-297, :568-713) -- against the JAX agent on
the fake environment, as tests/test_agents_units.py::
test_frontier_exploration_end_to_end drives it.

The two agents step their own copy of the environment (equal frames,
tests/test_torch_host_copies.py); the port's build steps take the JAX
agent's draws and world points (``torch_parity.inject_jax_build``), so
the top-down map that picks each frontier target is equal, and with it
every pose the flows push, the steps counted, the heights recorded and
the store's integer fields.
"""

import dataclasses

import numpy as np
import jax
import pytest

from bsc_nav_tpu.agents import spatial_memory as jsm
from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.env.fake import FakeNavEnv as JFakeNavEnv
from bsc_nav_tpu.env.pathfinding import AgentState as JAgentState
from bsc_nav_tpu.env.pathfinding import Quat as JQuat
from bsc_nav_tpu.models import vit as jv
from bsc_nav_tpu_torch.agents import spatial_memory as tsm
from bsc_nav_tpu_torch.config import small_test_config as t_small_config
from bsc_nav_tpu_torch.env.fake import FakeNavEnv
from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models.weights import vit_from_jax_params

from torch_parity import inject_jax_build, store_fields_equal

VIT = dict(img_size=28, patch_size=14, dim=32, depth=1, heads=2,
           num_registers=0)


def _with_agent(cfg, **agent):
    return cfg.replace(agent=dataclasses.replace(cfg.agent, **agent))


def _pair(seed=5, **agent):
    """(JAX agent, port agent, port config) on small_test_config and the
    fake environment of ``seed``, the same ViT weights; each agent logs
    the poses it pushes."""
    jcfg = _with_agent(small_test_config(), **agent)
    tcfg = _with_agent(t_small_config(), **agent)
    params = jv.init_params(jv.ViTConfig(**VIT), jax.random.PRNGKey(0))
    jenv = JFakeNavEnv(jcfg, seed=seed)
    jenv.reset(init_state=JAgentState(np.zeros(3), JQuat()), build_map=True)
    tenv = FakeNavEnv(tcfg, seed=seed)
    tenv.reset(init_state=AgentState(np.zeros(3), Quat()), build_map=True)
    jmem = jsm.VoxelTokenMemory(jcfg, env=jenv, perception=jsm.Perception.
                                create(jcfg, jv.ViTConfig(**VIT), params,
                                       batch_size=4))
    tmem = tsm.VoxelTokenMemory(tcfg, env=tenv, perception=tsm.Perception.
                                create(tcfg, tv.ViTConfig(**VIT),
                                       vit_from_jax_params(
                                           jax.tree_util.tree_map(
                                               np.asarray, params),
                                           tv.ViTConfig(**VIT),
                                           device="cpu"),
                                       batch_size=4, device="cpu"))
    inject_jax_build(tmem, tcfg)
    for mem in (jmem, tmem):
        mem.pushed = []
        push = mem.push_frame

        def logged(obs, pose, push=push, log=mem.pushed):
            log.append(np.array(pose, np.float32))
            return push(obs, pose)
        mem.push_frame = logged
    return jmem, tmem, tcfg


def assert_same_walk(jmem, tmem, cfg):
    assert len(tmem.pushed) == len(jmem.pushed) > 0
    np.testing.assert_array_equal(np.stack(tmem.pushed),
                                  np.stack(jmem.pushed))
    assert tmem.step_count == jmem.step_count
    assert tmem.base_height == jmem.base_height
    store_fields_equal(jmem.state, tmem.state, cfg)


def test_explore_entire_space_matches_jax():
    """Two frontier iterations: the same poses pushed, steps, heights and
    store as the JAX agent; the known and navigable masks equal."""
    jmem, tmem, cfg = _pair()
    for mem in (jmem, tmem):
        mem.explore_entire_space(max_iterations=2, save=False)
    assert_same_walk(jmem, tmem, cfg)
    assert tmem.step_count > 24 and int(tmem.state.num_voxels) > 100
    np.testing.assert_array_equal(tmem._known_mask(), jmem._known_mask())
    origin = np.asarray(tmem.Env.original_state.position)
    nav = tmem._navigable_mask(origin)
    np.testing.assert_array_equal(nav, jmem._navigable_mask(origin))
    assert 0.1 < nav.mean() < 1.0 and tmem._known_mask().sum() > 50
    np.testing.assert_array_equal(tmem._grid2loc_2d(10.5, 40.0, origin),
                                  jmem._grid2loc_2d(10.5, 40.0, origin))


def test_exploring_create_memory_matches_jax():
    """Three random same-island waypoints with a turn in place at each
    (the pathfinders' seeded draws agree): the same walk as the JAX
    agent's; ``create_memory`` takes the same flow."""
    jmem, tmem, cfg = _pair(seed=3, random_move_num=3)
    jmem.exploring_create_memory(save=False)
    tmem.exploring_create_memory(save=False)
    assert_same_walk(jmem, tmem, cfg)
    assert len(tmem.base_height) >= 3
    calls = []
    tmem.exploring_create_memory = lambda: calls.append(1)
    tmem.create_memory()
    assert calls == [1]


def test_exploration_check_catches_a_fault():
    """A frontier cell mapped to the world with its row and column
    swapped sends the walk elsewhere: the comparison must fail."""
    jmem, tmem, cfg = _pair()
    to_world = tmem._grid2loc_2d
    tmem._grid2loc_2d = lambda x, y, origin: to_world(y, x, origin)
    for mem in (jmem, tmem):
        mem.explore_entire_space(max_iterations=2, save=False)
    with pytest.raises(AssertionError):
        assert_same_walk(jmem, tmem, cfg)


def test_excute_counts_steps_and_heights():
    """"stop" is skipped; every tenth step records the agent's height;
    each other step pushes its frame."""
    jmem, tmem, cfg = _pair(seed=1)
    actions = (["move_forward", "stop"] * 6 + ["turn_left"] * 9
               + ["stop", "look_down"])
    for mem in (jmem, tmem):
        obs = mem.Env.sims.get_sensor_observations(0)
        mem.excute(obs, actions)
        mem.flush()
    assert tmem.step_count == 16
    assert len(tmem.base_height) == 1
    assert_same_walk(jmem, tmem, cfg)


def test_reference_aliases_and_public_surface():
    """gs / cs / minh / maxh as JAX's, and every public method and
    attribute of the JAX agent present on the port's."""
    jmem, tmem, _ = _pair()
    for name in ("gs", "cs", "minh", "maxh", "step_count"):
        assert getattr(tmem, name) == getattr(jmem, name), name
    public = {n for n in dir(jmem) if not n.startswith("_")}
    missing = sorted(n for n in public if not hasattr(tmem, n))
    assert not missing, missing
