"""Port parity: the segmented store (bsc_nav_tpu/memory/segments.py) --
rotation, the int8 freeze, the host spill, the merged query -- and
``VoxelTokenMemory(segmented=True)`` (bsc_nav_tpu/agents/
spatial_memory.py:139-146, :245-248, :375-380, :426-464, :527-544),
against the JAX package on the CPU.

Segments built from the same frames with JAX's draws injected hold equal
integer fields; f32 rows within 1e-5 relative, int8 codes byte for byte
(up to a code whose quotient lies within an ulp of a half, as in
tests/test_torch_store_int8.py).  ``SegmentedStore.localize`` on equal
segments gives JAX's positions in JAX's order, each score within the f32
dot bound of tests/test_torch_similarity.py (unit query, D = 32: 2
gamma_33 plus 1e-5), wherever JAX's consecutive scores lie more than
twice that apart, so that the order cannot flip (``assert_same_ranking``
says what it holds of nearer scores).  Agent queries run
each package's own ViT (tokens ~1e-6 apart) and are compared as in
tests/test_torch_batch_query.py: the top-K set above the K-th score,
scores within 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.agents import spatial_memory as jsm
from bsc_nav_tpu.config import QueryConfig as JQueryConfig
from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.env.fake import FakeNavEnv as JFakeNavEnv
from bsc_nav_tpu.env.pathfinding import AgentState as JAgentState
from bsc_nav_tpu.env.pathfinding import Quat as JQuat
from bsc_nav_tpu.memory import ingest as jing
from bsc_nav_tpu.memory.segments import SegmentedStore as JSegmentedStore
from bsc_nav_tpu.models import vit as jv
from bsc_nav_tpu_torch.agents import spatial_memory as tsm
from bsc_nav_tpu_torch.config import QueryConfig
from bsc_nav_tpu_torch.config import small_test_config as t_small_config
from bsc_nav_tpu_torch.env.fake import FakeNavEnv
from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat
from bsc_nav_tpu_torch.memory import ingest as ting
from bsc_nav_tpu_torch.memory import segments as tseg
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models.weights import vit_from_jax_params

from test_ingest import make_frames
from test_torch_batch_query import _same_results
from test_torch_store_int8 import assert_codes_equal
from torch_parity import (ingest_draws, inject_jax_build, segments_from_jax,
                          store_fields_equal, tensors)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
U = 2.0 ** -24
SCORE_BOUND = 1e-5 + 2 * 33 * U / (1 - 33 * U)     # the f32 dot bound, D 32
VIT = dict(img_size=28, patch_size=14, dim=32, depth=1, heads=2,
           num_registers=0)


def tiny_cfg(cfg=None):
    """tests/test_segments.py's config: 248 slots, so that a few frames
    rotate."""
    cfg = cfg or small_test_config()
    return cfg.replace(memory=dataclasses.replace(
        cfg.memory, voxel_capacity=248))


def _frames(cfg, n):
    """n single-frame batches, each 1.2 m on from the last."""
    out = []
    for b in range(n):
        rgb, depth, poses, tokens = make_frames(cfg, 1, seed=b)
        poses[:, :3] = b * 1.2
        out.append((rgb, depth, poses, tokens))
    return out


def _build_both(cfg, dtype, max_dev, freeze, n=5):
    """The same batches into a JAX and a port SegmentedStore, JAX's draws
    injected, each rotated after each batch; the rotations must agree."""
    jd, td = DTYPES[dtype]
    jseg = JSegmentedStore(cfg.memory, store_dtype=jd,
                           max_device_segments=max_dev, freeze_dtype=freeze)
    tseg_ = tseg.SegmentedStore(cfg.memory, store_dtype=td,
                                max_device_segments=max_dev,
                                freeze_dtype=freeze, device="cpu")
    key = jax.random.PRNGKey(0)
    for rgb, depth, poses, tokens in _frames(cfg, n):
        key, sub = jax.random.split(key)
        jseg.state, _ = jing.ingest_frames(
            jseg.state, *map(jnp.asarray, (rgb, depth, poses, tokens)), sub,
            cfg)
        pix, repl = ingest_draws(sub, cfg, 1)
        tseg_.state, _ = ting.ingest_frames(
            tseg_.state, *tensors(rgb, depth, poses, tokens), None, cfg,
            pix=torch.from_numpy(pix), repl_idx=torch.from_numpy(repl))
        assert jseg.rotate_if_full() == tseg_.rotate_if_full()
    return jseg, tseg_


def _rows_equal(got, want, rows):
    got, want = got[:rows], np.asarray(want)[:rows]
    if got.dtype == torch.int8:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32),
                                   rtol=1e-5, atol=1e-6)


def assert_segments_equal(tseg_, jseg, cfg):
    """Segment counts, voxel totals, and every segment's integer fields and
    rows."""
    assert tseg_.num_segments == jseg.num_segments
    assert len(tseg_.device_segments) == len(jseg.device_segments)
    assert len(tseg_.host_segments) == len(jseg.host_segments)
    assert tseg_.total_voxels() == jseg.total_voxels()
    K = cfg.memory.cache_size
    for t, j in zip([tseg_.state] + tseg_.device_segments,
                    [jseg.state] + jseg.device_segments):
        store_fields_equal(j, t, cfg)
        rows = int(j.num_voxels) * K
        assert t.feats.dtype == {jnp.dtype(jnp.int8): torch.int8,
                                 jnp.dtype(jnp.float32): torch.float32,
                                 jnp.dtype(jnp.bfloat16): torch.bfloat16}[
            j.feats.dtype]
        _rows_equal(t.feats, j.feats, rows)
        for f in ("feat_norm", "feat_scale"):
            a, b = getattr(t, f), np.asarray(getattr(j, f))
            assert tuple(a.shape) == b.shape, f
            if b.shape[0] > 1:
                np.testing.assert_allclose(a[:rows].numpy(), b[:rows],
                                           rtol=1e-6, err_msg=f)
    for t, j in zip(tseg_.host_segments, jseg.host_segments):
        assert (t["n"], t["K"]) == (j["n"], j["K"])
        for f in ("feat_count", "slot_pos"):
            np.testing.assert_array_equal(t[f].numpy(), j[f], err_msg=f)
        assert t["feats"].shape == j["feats"].shape
        _rows_equal(t["feats"], j["feats"], j["feats"].shape[0])
        np.testing.assert_allclose(t["feat_norm"].numpy(), j["feat_norm"],
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype,max_dev,freeze", [
    ("float32", 1, "int8"), ("float32", 0, "int8"), ("float32", 2, None),
    ("bfloat16", 1, "int8"), ("int8", 0, "int8"), ("bfloat16", 0, None)])
def test_segmented_store_matches_jax(dtype, max_dev, freeze):
    """Rotations at the same batches, as many device and spilled segments,
    equal voxel totals past one store's capacity, equal segments (the int8
    freeze byte for byte on equal rows)."""
    cfg = tiny_cfg()
    jseg, tseg_ = _build_both(cfg, dtype, max_dev, freeze)
    assert jseg.num_segments >= 3
    assert jseg.total_voxels() > cfg.memory.voxel_capacity
    if max_dev < jseg.num_segments - 1:
        assert len(tseg_.host_segments) >= 1
    assert_segments_equal(tseg_, jseg, cfg)


def test_int8_freeze_codes_match_jax():
    """The freeze quantizes f32 rows as JAX does: codes equal but within
    an ulp of a half, scales and int8-row norms to the bit."""
    cfg = tiny_cfg()
    jseg, tseg_ = _build_both(cfg, "float32", 3, "int8", n=4)
    assert tseg_.device_segments
    for t, j in zip(tseg_.device_segments, jseg.device_segments):
        rows = int(j.num_voxels) * cfg.memory.cache_size
        np.testing.assert_array_equal(t.feat_scale[:rows].numpy(),
                                      np.asarray(j.feat_scale)[:rows])
        np.testing.assert_array_equal(t.feat_norm[:rows].numpy(),
                                      np.asarray(j.feat_norm)[:rows])
        assert_codes_equal(t.feats[:rows].numpy(),
                           np.asarray(j.feats)[:rows],
                           np.asarray(j.feats, np.float32)[:rows],
                           np.asarray(j.feat_scale)[:rows])


def test_fresh_segment_does_not_alias_the_frozen_maps(monkeypatch):
    """Fault case: a fresh segment sharing the frozen segment's top-down
    maps (as JAX's immutable arrays may) lets later flushes write into the
    frozen segment; the comparison must catch it.  The port copies."""
    cfg = tiny_cfg()
    rotate = tseg.SegmentedStore.rotate_if_full

    def aliased(self):
        rotated = rotate(self)
        if rotated:
            frozen = self.device_segments[-1] if self.device_segments \
                else None
            if frozen is not None:
                self.state.cv_map = frozen.cv_map
                self.state.max_height = frozen.max_height
        return rotated

    jseg, tseg_ = _build_both(cfg, "float32", 2, "int8")
    assert_segments_equal(tseg_, jseg, cfg)
    monkeypatch.setattr(tseg.SegmentedStore, "rotate_if_full", aliased)
    jseg, tseg_ = _build_both(cfg, "float32", 2, "int8")
    with pytest.raises(AssertionError):
        assert_segments_equal(tseg_, jseg, cfg)


def assert_same_ranking(tpos, tsc, jpos, jsc):
    """Scores within SCORE_BOUND, and JAX's positions in JAX's order
    wherever JAX's consecutive scores lie more than 2 SCORE_BOUND apart
    (there the order cannot flip); a run of nearer scores holds the same
    positions in either order, and a run at the end, which the top-K cut
    may split, is held by its scores alone."""
    assert len(tsc) == len(jsc)
    np.testing.assert_allclose(tsc, jsc, atol=SCORE_BOUND, rtol=0)
    run = np.concatenate([[0], np.cumsum(np.diff(jsc) < -2 * SCORE_BOUND)])
    for r in np.unique(run):
        at = np.flatnonzero(run == r)
        if len(at) == 1:
            np.testing.assert_array_equal(tpos[at], jpos[at])
        elif r != run[-1]:
            assert (set(map(tuple, tpos[at].tolist()))
                    == set(map(tuple, jpos[at].tolist())))


def _randomize_rows(jseg, seed):
    """Distinct random rows in every segment of a JAX SegmentedStore (so
    that no two voxels tie), int8 codes where a segment holds int8."""
    rng = np.random.default_rng(seed)

    def rows(shape, int8):
        if int8:
            f = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:
            f = rng.normal(size=shape).astype(np.float32)
        return f, np.linalg.norm(f.astype(np.float32), axis=1)

    for i, s in enumerate([jseg.state] + jseg.device_segments):
        f, n = rows(s.feats.shape, s.feats.dtype == jnp.int8)
        s = s.replace(feats=jnp.asarray(f, s.feats.dtype),
                      feat_norm=jnp.asarray(n, jnp.float32))
        if i == 0:
            jseg.state = s
        else:
            jseg.device_segments[i - 1] = s
    for h in jseg.host_segments:
        h["feats"], h["feat_norm"] = rows(h["feats"].shape,
                                          h["feats"].dtype == np.int8)


@pytest.mark.parametrize("masks", [
    {}, {"use_region": True}, {"use_floor": True},
    {"use_region": True, "use_floor": True}])
@pytest.mark.parametrize("max_dev", [0, 1])
def test_localize_matches_jax(masks, max_dev):
    """Equal segments (active f32, int8 frozen on the device and spilled):
    the merged, position-deduplicated top-16 as JAX's, in order, for
    queries along stored rows and random ones; with a region radius, a
    floor range, both."""
    cfg = tiny_cfg()
    jseg, _ = _build_both(cfg, "float32", max_dev, "int8")
    _randomize_rows(jseg, seed=max_dev)
    tseg_ = segments_from_jax(jseg, torch.float32)
    assert len(tseg_.host_segments) >= 1
    rng = np.random.default_rng(5)
    D = cfg.memory.token_dim
    pos0 = np.asarray(jseg.state.slot_pos)[: int(jseg.state.num_voxels)]
    grid = pos0[len(pos0) // 2].astype(np.int32)
    floor = np.array([grid[2] - 4, grid[2] + 4], np.int32)
    queries = [rng.normal(size=D).astype(np.float32) for _ in range(3)]
    queries.append(np.array(jseg.host_segments[0]["feats"][3],
                              np.float32))
    queries.append(np.array(jseg.state.feats[5], np.float32))
    for q in queries:
        kw_j, kw_t = {}, {}
        if masks.get("use_region"):
            kw_j.update(use_region=True, curr_grid=jnp.asarray(grid),
                        region_radius=12.0)
            kw_t.update(use_region=True, curr_grid=torch.from_numpy(grid),
                        region_radius=12.0)
        if masks.get("use_floor"):
            kw_j.update(use_floor=True, floor_range=jnp.asarray(floor))
            kw_t.update(use_floor=True, floor_range=torch.from_numpy(floor))
        jpos, jsc = jseg.localize(jnp.asarray(q), top_k=16, **kw_j)
        tpos, tsc = tseg_.localize(torch.from_numpy(q), top_k=16, **kw_t)
        assert len(jsc) > 4
        assert tpos.dtype == np.int32 and tsc.dtype == np.float32
        assert_same_ranking(tpos, tsc, jpos, jsc)
        if masks.get("use_region"):
            assert np.all(((tpos - grid) ** 2).sum(axis=1) <= 144)
        if masks.get("use_floor"):
            assert np.all((tpos[:, 2] >= floor[0]) & (tpos[:, 2] <= floor[1]))


def test_merge_keeps_the_best_score_of_a_revisited_voxel():
    """tests/test_segments.py's hand-made case on the port alone: a voxel
    in a spilled segment and again, with a better token, in the active
    one comes out once, with the better score."""
    cfg = tiny_cfg()
    seg = tseg.SegmentedStore(cfg.memory, max_device_segments=0,
                              device="cpu")
    rng = np.random.default_rng(0)
    D, K = cfg.memory.token_dim, cfg.memory.cache_size
    q = rng.normal(size=D).astype(np.float32)

    def put(state, entries):
        for i, (p, t) in enumerate(entries):
            state.feats[i * K] = torch.from_numpy(t)
            state.feat_norm[i * K] = float(np.linalg.norm(t))
            state.feat_count[i] = 1
            state.slot_pos[i] = torch.tensor(p, dtype=torch.int32)
        state.num_voxels.fill_(len(entries))
        state.initialized.fill_(True)

    put(seg.state, [((5, 5, 5), q + rng.normal(size=D).astype(np.float32)
                     * 2), ((9, 9, 9), rng.normal(size=D).astype(
                         np.float32))])
    seg.rotate_threshold = 0
    assert seg.rotate_if_full()
    assert len(seg.host_segments) == 1 and seg.state.num_voxels == 0
    assert seg.host_segments[0]["feats"].dtype == torch.int8
    put(seg.state, [((5, 5, 5), q * 2.0)])
    pos, score = seg.localize(torch.from_numpy(q), top_k=8)
    assert [tuple(p) for p in pos] == [(5, 5, 5), (9, 9, 9)]
    np.testing.assert_allclose(score[0], 1.0, atol=1e-4)
    assert score[1] < score[0]


def test_segmented_store_allocates_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tseg.SegmentedStore(tiny_cfg().memory)


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------

class _Painter:
    """A plain-callable imagination: a fixed image group for any text."""

    def __init__(self, imgs):
        self.imgs = imgs

    def __call__(self, prompt):
        return self.imgs


class _CoreImagination(_Painter):
    """A plain callable that also has ``imagine_core``, which a segmented
    store of several segments must not take."""

    def imagine_core(self, *a):
        raise AssertionError("the fused text query ran on segments")


def _agents(max_dev, imagination_cls=_Painter):
    """The JAX and the port agent on tiny_cfg, segmented, the same ViT
    weights, the port's build steps taking the JAX agent's draws and
    points; 3 x (8 turns + 4 steps forward) each, flushed."""
    jcfg = tiny_cfg().replace(query=JQueryConfig(
        top_k=16, query_width=28, query_height=28))
    tcfg = tiny_cfg(t_small_config()).replace(query=QueryConfig(
        top_k=16, query_width=28, query_height=28))
    params = jv.init_params(jv.ViTConfig(**VIT), jax.random.PRNGKey(0))
    jenv = JFakeNavEnv(jcfg, seed=7)
    jenv.reset(init_state=JAgentState(np.zeros(3), JQuat()), build_map=True)
    tenv = FakeNavEnv(tcfg, seed=7)
    tenv.reset(init_state=AgentState(np.zeros(3), Quat()), build_map=True)
    painter_views = None
    mems = []
    for cfg, env, mod, perc in (
            (jcfg, jenv, jsm, lambda c: jsm.Perception.create(
                c, jv.ViTConfig(**VIT), params, batch_size=4)),
            (tcfg, tenv, tsm, lambda c: tsm.Perception.create(
                c, tv.ViTConfig(**VIT), vit_from_jax_params(
                    jax.tree_util.tree_map(np.asarray, params),
                    tv.ViTConfig(**VIT), device="cpu"), batch_size=4,
                device="cpu"))):
        obs = env.sims.get_sensor_observations(0)
        if painter_views is None:
            painter_views = np.stack([obs["rgb"][:, :, :3]] * 2)
        mem = mod.VoxelTokenMemory(
            cfg, env=env, perception=perc(cfg), segmented=True,
            max_device_segments=max_dev,
            imagination=imagination_cls(painter_views))
        if mod is tsm:
            inject_jax_build(mem, cfg)
        for _ in range(3):
            obs = mem.excute(obs, ["turn_left"] * 8 + ["move_forward"] * 4)
        mem.flush()
        mems.append((mem, obs))
    return mems, tcfg


@pytest.mark.parametrize("max_dev", [0, 1])
def test_segmented_agent_matches_jax(max_dev):
    """VoxelTokenMemory(segmented=True): the same segments as the JAX
    agent's; an image query, a region query, a batch of two views with
    radii and a text prompt through a plain-callable imagination give the
    JAX agent's top-K."""
    ((jmem, jobs), (tmem, tobs)), cfg = _agents(max_dev)
    assert tmem.segments.num_segments >= 2
    assert tmem.state is tmem.segments.state
    assert tmem.step_count == jmem.step_count == 36
    assert tmem.base_height == jmem.base_height
    assert_segments_equal(tmem.segments, jmem.segments, cfg)
    view = np.asarray(tobs["rgb"][:, :, :3])
    np.testing.assert_array_equal(view, np.asarray(jobs["rgb"][:, :, :3]))
    got = tmem.voxel_localized(view, K=16)
    want = jmem.voxel_localized(view, K=16)
    _same_results([got], [want], atol=1e-4)
    centre = want[0][0]
    _same_results([tmem.voxel_localized(view, K=16, region_radius=10.0,
                                        curr_grid=centre)],
                  [jmem.voxel_localized(view, K=16, region_radius=10.0,
                                        curr_grid=centre)], atol=1e-4)
    views = [view, np.asarray(tmem.Env.sims.get_sensor_observations(0)[
        "rgb"][:, :, :3])]
    radii = [np.inf, 10.0]
    _same_results(tmem.voxel_localized_batch(views, K=16, region_radii=radii,
                                             curr_grid=centre),
                  jmem.voxel_localized_batch(views, K=16, region_radii=radii,
                                             curr_grid=centre), atol=1e-4)
    _same_results([tmem.voxel_localized("a red box", K=16)],
                  [jmem.voxel_localized("a red box", K=16)], atol=1e-4)


def test_segmented_text_gate():
    """On several segments a text prompt skips the fused text query
    (``voxel_localized_async`` returns None, ``imagine_core`` is never
    called) and goes through ``imaginary`` and the pooled query, as the
    JAX agent's."""
    ((jmem, _), (tmem, _)), _ = _agents(0, _CoreImagination)
    assert tmem.segments.num_segments > 1
    assert tmem.voxel_localized_async("a sofa") is None
    _same_results([tmem.voxel_localized("a sofa", K=16)],
                  [jmem.voxel_localized("a sofa", K=16)], atol=1e-4)
