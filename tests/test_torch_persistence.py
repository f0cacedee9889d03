"""Port parity: persistence of the voxel store
(bsc_nav_tpu/memory/persistence.py) -- the dense ``.npz`` snapshot and the
reference's HDF5 bundle, each written by one package and read by the
other, in f32, bf16 and int8 -- and ``VoxelTokenMemory.save`` /
``load_memory`` with the single-floor range (bsc_nav_tpu/agents/
spatial_memory.py:669-710, bsc_nav_tpu/memory/floors.py).

Loaded stores are compared field by field, array-equal (bf16 as its f32
widening): the formats carry the bytes, so nothing is within a tolerance
but the rebased frame chain (two LU inverses of one 4x4, 1e-6).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.agents import spatial_memory as jsm
from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.env.fake import BoxScene as JBoxScene
from bsc_nav_tpu.env.fake import FakeNavEnv as JFakeNavEnv
from bsc_nav_tpu.env.pathfinding import AgentState as JAgentState
from bsc_nav_tpu.env.pathfinding import Quat as JQuat
from bsc_nav_tpu.memory import ingest as jing
from bsc_nav_tpu.memory import persistence as jp
from bsc_nav_tpu.memory import store as jstore
from bsc_nav_tpu_torch.agents import spatial_memory as tsm
from bsc_nav_tpu_torch.config import small_test_config as t_small_config
from bsc_nav_tpu_torch.env.fake import BoxScene, FakeNavEnv
from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat
from bsc_nav_tpu_torch.memory import persistence as tp
from bsc_nav_tpu_torch.memory.store import VoxelStoreState
from bsc_nav_tpu_torch.models import vit as tv

from test_ingest import make_frames

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _np(a):
    """A JAX array or a tensor as numpy, bf16 widened to f32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_stores_equal(tstate, jstate):
    for name in VoxelStoreState.__dataclass_fields__:
        a, b = _np(getattr(tstate, name)), _np(getattr(jstate, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def to_port(jstate) -> VoxelStoreState:
    """A port store holding a JAX store's arrays (bf16 rows included)."""
    out = {}
    for name in VoxelStoreState.__dataclass_fields__:
        a = np.asarray(getattr(jstate, name))
        t = torch.from_numpy(_np(a).copy())
        out[name] = t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t
    return VoxelStoreState(**out)


@pytest.fixture(scope="module")
def jax_stores():
    """small_test_config; two batches of frames ingested by the JAX
    package into an f32, a bf16 and an int8 store."""
    cfg = small_test_config()
    batches = [make_frames(cfg, 2, seed=50 + i) for i in range(2)]
    out = {}
    for name, (jd, _) in DTYPES.items():
        s = jstore.init_store(cfg.memory, jd)
        key = jax.random.PRNGKey(4)
        for b in batches:
            key, sub = jax.random.split(key)
            s, _ = jing.ingest_frames(s, *map(jnp.asarray, b), sub, cfg)
        out[name] = s
    assert int(out["int8"].num_voxels) > 100
    return cfg, out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_npz_jax_to_port(jax_stores, tmp_path, dtype):
    """A snapshot JAX saved loads in the port as JAX loads it."""
    cfg, stores = jax_stores
    path = str(tmp_path / "jax.npz")
    jp.save_npz(stores[dtype], path)
    jd, td = DTYPES[dtype]
    got = tp.load_npz(path, cfg.memory, store_dtype=td, device="cpu")
    assert got.feats.dtype == td
    assert_stores_equal(got, jp.load_npz(path, cfg.memory, store_dtype=jd))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_npz_port_to_jax(jax_stores, tmp_path, dtype):
    """A snapshot the port saved holds the same arrays as JAX's under the
    same keys, and loads in JAX as JAX's own does."""
    cfg, stores = jax_stores
    jd, td = DTYPES[dtype]
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tp.save_npz(to_port(stores[dtype]), tpath)
    jp.save_npz(stores[dtype], jpath)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_stores_equal(to_port(jp.load_npz(tpath, cfg.memory,
                                            store_dtype=jd)),
                        jp.load_npz(jpath, cfg.memory, store_dtype=jd))


def _bundle_equal(a, b):
    """Two reference bundles hold the same arrays, groups and JSON."""
    import h5py
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        if n.endswith(".npy"):
            x, y = np.load(os.path.join(a, n)), np.load(os.path.join(b, n))
            assert x.dtype == y.dtype, n
            np.testing.assert_array_equal(x, y, err_msg=n)
        elif n.endswith(".json"):
            assert open(os.path.join(a, n)).read() == open(
                os.path.join(b, n)).read()
    with h5py.File(os.path.join(a, "feat.h5df")) as fa, \
            h5py.File(os.path.join(b, "feat.h5df")) as fb:
        assert sorted(fa) == sorted(fb) and len(fa) > 100
        for g in fa:
            for d in ("features", "distances"):
                np.testing.assert_array_equal(fa[g][d][()], fb[g][d][()])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reference_format_both_ways(jax_stores, tmp_path, dtype):
    """Each package writes the same bundle (the int8 rows dequantized,
    bf16 widened); a bundle either wrote loads in the other, the int8
    store requantized on the host, as the writer's own loader does."""
    cfg, stores = jax_stores
    jd, td = DTYPES[dtype]
    meta = dict(original_pos=[0.5, 0.0, -1.25], base_height=[0.1, 0.12],
                long_memory=[{"label": "bed", "loc": [3, 4, 5],
                              "confidence": 0.9}])
    ja, ta = str(tmp_path / "jax"), str(tmp_path / "port")
    jp.save_reference_format(stores[dtype], ja, cfg.memory, **meta)
    tp.save_reference_format(to_port(stores[dtype]), ta, cfg.memory, **meta)
    _bundle_equal(ja, ta)
    want, jmeta = jp.load_reference_format(ja, cfg.memory, store_dtype=jd)
    got, tmeta = tp.load_reference_format(ja, cfg.memory, store_dtype=td,
                                          device="cpu")
    assert_stores_equal(got, want)
    assert_stores_equal(to_port(jp.load_reference_format(
        ta, cfg.memory, store_dtype=jd)[0]), want)
    assert tmeta["long_memory"] == jmeta["long_memory"] == meta[
        "long_memory"]
    assert tmeta["map_height"] == jmeta["map_height"]
    for k in ("original_pos", "base_height"):
        np.testing.assert_array_equal(tmeta[k], jmeta[k])


VIT = dict(img_size=28, patch_size=14, dim=32, depth=1, heads=2,
           num_registers=1)


def _agent_pair(tmp_path, single_floor):
    """A JAX agent after 8 frames of a spin (heights sampled on two
    floors by hand), and a port agent holding its store and metadata."""
    from bsc_nav_tpu.models import vit as jv
    cfg, tcfg = (c.replace(agent=dataclasses.replace(
        c.agent, load_single_floor=single_floor))
        for c in (small_test_config(), t_small_config()))
    jenv = JFakeNavEnv(cfg, scene=JBoxScene.default(), seed=1)
    jenv.reset(init_state=JAgentState(np.array([0.3, 0.0, -0.2]),
                                      JQuat.from_yaw(0.0)), build_map=True)
    tenv = FakeNavEnv(tcfg, scene=BoxScene.default(), seed=1)
    tenv.reset(init_state=AgentState(np.array([0.3, 0.0, -0.2]),
                                     Quat.from_yaw(0.0)), build_map=True)
    jparams = jv.init_params(jv.ViTConfig(**VIT), jax.random.PRNGKey(0))
    jmem = jsm.VoxelTokenMemory(
        cfg, jenv, jsm.Perception.create(cfg, jv.ViTConfig(**VIT), jparams,
                                         batch_size=4),
        memory_path=str(tmp_path / "jax_mem"))
    obs = jenv.sims.get_sensor_observations(0)
    for _ in range(8):
        jmem.push_frame(obs, jenv.agent_pose_vec())
        obs = jenv.step("turn_left")
    jmem.flush()
    jmem.base_height = [0.0, 0.02, -0.01, 0.01, 0.0, 3.0, 3.02, 2.99,
                        3.01, 3.0]
    jmem.long_memory_dict = [{"label": "sofa", "loc": [10, 12, 33],
                              "confidence": 0.8}]
    tmem = tsm.VoxelTokenMemory(
        tcfg, tenv, tsm.Perception.create(tcfg, tv.ViTConfig(**VIT),
                                          batch_size=4, device="cpu"),
        memory_path=str(tmp_path / "port_mem"))
    assert tmem.memory_save_path == str(tmp_path / "port_mem")
    tmem.state = to_port(jmem.state)
    tmem.base_height = list(jmem.base_height)
    tmem.long_memory_dict = list(jmem.long_memory_dict)
    return jmem, tmem


def _loaded_equal(tmem, jmem):
    assert_stores_equal(
        dataclasses.replace(tmem.state, inv_init_base_tf=torch.from_numpy(
            np.array(jmem.state.inv_init_base_tf))), jmem.state)
    np.testing.assert_allclose(tmem.state.inv_init_base_tf.numpy(),
                               np.asarray(jmem.state.inv_init_base_tf),
                               atol=1e-6)
    np.testing.assert_allclose(tmem._inv_init_host, jmem._inv_init_host,
                               atol=1e-6)
    assert tmem.long_memory_dict == jmem.long_memory_dict
    np.testing.assert_array_equal(tmem.base_height, jmem.base_height)
    np.testing.assert_array_equal(tmem.Env.original_state.position,
                                  jmem.Env.original_state.position)
    assert (tmem.floor_min_height, tmem.floor_max_height) == (
        jmem.floor_min_height, jmem.floor_max_height)


@pytest.mark.parametrize("single_floor", [False, True])
def test_save_and_load_memory_match_jax_agent(tmp_path, single_floor):
    """``save`` writes the JAX agent's bundle; ``load_memory`` of either
    agent's bundle gives the JAX agent's loaded state: the store, the
    long-term memory, the heights, the origin, the frame chain rebased to
    it, and (``load_single_floor``) the floor range from the heights'
    DBSCAN."""
    jmem, tmem = _agent_pair(tmp_path, single_floor)
    jmem.save()
    tmem.save()
    _bundle_equal(jmem.memory_save_path, tmem.memory_save_path)
    # each agent loads the other's bundle, standing at a new pose
    for mem in (jmem, tmem):
        mem.Env.agent.set_state(type(mem.Env.agent.get_state())(
            np.array([1.0, 3.01, 0.5]), type(
                mem.Env.agent.get_state().rotation).from_yaw(0.3)))
    jmem.load_memory(path=tmem.memory_save_path)
    tmem.load_memory(path=jmem.memory_save_path)
    _loaded_equal(tmem, jmem)
    if single_floor:
        assert tmem.floor_min_height is not None
    # build_map resets the environment and loads nothing
    before = tmem.state
    tmem.load_memory(build_map=True)
    assert tmem.state is before
