"""Port parity: batched queries -- ``query.localize_batch``,
``pipeline.make_query_batch_step`` and ``token_similarity_map``
(bsc_nav_tpu/memory/{query,pipeline}.py), ``VoxelTokenMemory.
voxel_localized_batch`` and ``Perception.pool_step`` (bsc_nav_tpu/agents/
spatial_memory.py) -- and the int8 W8A8 encoder (``vit.quantize_params``,
``encoder_int8``), against the JAX package on the CPU.

Top-K results are compared as sets above the K-th score (ties may order
differently); scores within 1e-5 where both sides scan the same pooled
vector, within 1e-4 where each side runs its own ViT (f32 tokens ~1e-6
apart).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.agents import spatial_memory as jsm
from bsc_nav_tpu.memory import pipeline as jpipe
from bsc_nav_tpu.memory import query as jq
from bsc_nav_tpu.models import vit as jv
from bsc_nav_tpu_torch.agents import spatial_memory as tsm
from bsc_nav_tpu_torch.memory import pipeline as tpipe
from bsc_nav_tpu_torch.memory import query as tq
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.models.weights import vit_from_jax_params

from test_torch_query import stores  # noqa: F401  (module fixture)
from test_torch_slice import VIT_KW, world  # noqa: F401  (module fixture)
from torch_parity import assert_same_topk, store_from_jax


def _floor(ts):
    heights = ts.slot_pos[:int(ts.num_voxels), 2].numpy()
    return np.asarray([np.percentile(heights, 25),
                       np.percentile(heights, 75)], np.int32)


def _queries(cfg, ts, Q, seed):
    """Q query vectors, per-query grid centres (live voxels within
    ``_floor``) and radii with inf (no region) among them."""
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(Q, cfg.memory.token_dim)).astype(np.float32)
    pos = ts.slot_pos[:int(ts.num_voxels)].numpy()
    lo, hi = _floor(ts)
    inside = np.flatnonzero((pos[:, 2] >= lo) & (pos[:, 2] <= hi))
    grids = pos[rng.choice(inside, size=Q)].astype(np.int32)
    radii = np.array([np.inf, 9.0, 14.0, np.inf, 5.0, 20.0, np.inf][:Q],
                     np.float32)
    return qs, grids, radii


@pytest.mark.parametrize("masks", [
    {},
    {"use_floor": True},
    {"use_region": True},
    {"use_region": True, "use_floor": True},
])
def test_localize_batch_matches_jax(stores, masks):  # noqa: F811
    """Each query's top-K set equal to JAX's, scores within 1e-5; an inf
    radius leaves its query unrestricted, and no voxel outside a finite
    radius is returned."""
    cfg, js, ts = stores
    qs, grids, radii = _queries(cfg, ts, 7, seed=2)
    floor = _floor(ts)
    jpos, jsc = jq.localize_batch(
        js, jnp.asarray(qs), top_k=48, floor_range=jnp.asarray(floor),
        curr_grid=jnp.asarray(grids), region_radii=jnp.asarray(radii),
        **masks)
    tpos, tsc = tq.localize_batch(
        ts, torch.from_numpy(qs), top_k=48,
        floor_range=torch.from_numpy(floor),
        curr_grid=torch.from_numpy(grids),
        region_radii=torch.from_numpy(radii), **masks)
    assert tpos.shape == (7, 48, 3) and tsc.shape == (7, 48)
    tpos, tsc = tpos.numpy(), tsc.numpy()
    assert np.isfinite(tsc).sum() > 100
    for j in range(7):
        assert np.isfinite(tsc[j]).any()
        assert_same_topk(tpos[j], tsc[j], np.asarray(jpos[j]),
                         np.asarray(jsc[j]), atol=1e-5)
        live = np.isfinite(tsc[j])
        if masks.get("use_region") and np.isfinite(radii[j]):
            d2 = ((tpos[j][live] - grids[j]) ** 2).sum(axis=1)
            assert np.all(d2 <= radii[j] ** 2)
        if masks.get("use_floor"):
            h = tpos[j][live][:, 2]
            assert np.all((h >= floor[0]) & (h <= floor[1]))


def test_localize_batch_rows_equal_single_queries_on_f32(stores):  # noqa: F811
    """On an f32 store both scans keep f32 queries: each row of the batch
    gives the single-query ``localize`` top-K."""
    cfg, _, ts = stores
    qs, grids, radii = _queries(cfg, ts, 3, seed=4)
    tpos, tsc = tq.localize_batch(ts, torch.from_numpy(qs), top_k=32)
    for j in range(3):
        pos, sc = tq.localize(ts, torch.from_numpy(qs[j]), top_k=32)
        assert_same_topk(tpos[j].numpy(), tsc[j].numpy(), pos.numpy(),
                         sc.numpy(), atol=1e-6)


def _jax_params(world):  # noqa: F811
    return jax.tree_util.tree_map(jnp.asarray, world[5])


def test_query_batch_step_matches_jax(world):  # noqa: F811
    """Q = 3 groups of 2 images: one ViT forward of 6, pooled per group,
    one Q-query scan; against JAX's step on JAX's store."""
    cfg, _, frames, batch, qimg, params = world
    jcfg = jv.ViTConfig(**VIT_KW)
    jparams = _jax_params(world)
    carry, _ = jpipe.make_build_step(cfg, jcfg)(
        (jsm.init_store(cfg.memory), jax.random.PRNGKey(7)), jparams,
        *map(jnp.asarray, batch))
    js = carry[0]
    imgs = np.stack([np.stack([frames[i][0], frames[i + 1][0]])
                     for i in (0, 4, 8)])
    imgs[0, 0] = qimg[0]
    jpos, jsc = jpipe.make_query_batch_step(cfg, jcfg)(
        js, jparams, jnp.asarray(imgs), top_k=16)
    model = vit_from_jax_params(params, tv.ViTConfig(**VIT_KW),
                                device="cpu")
    tpos, tsc = tpipe.make_query_batch_step(cfg, model.cfg)(
        store_from_jax(js), model, torch.from_numpy(imgs), top_k=16)
    assert tpos.shape == (3, 16, 3)
    for j in range(3):
        assert np.isfinite(np.asarray(jsc[j])).all()
        assert_same_topk(tpos[j].numpy(), tsc[j].numpy(),
                         np.asarray(jpos[j]), np.asarray(jsc[j]), atol=1e-4)


def test_token_similarity_map_matches_jax(world):  # noqa: F811
    """[nh, nw] cosines of unit f32 vectors: 1e-5 abs."""
    cfg, _, frames, _, qimg, params = world
    jcfg = jv.ViTConfig(**VIT_KW)
    want = np.asarray(jpipe.token_similarity_map(
        _jax_params(world), jnp.asarray(qimg[0]), jnp.asarray(frames[2][0]),
        jcfg, cfg))
    model = vit_from_jax_params(params, tv.ViTConfig(**VIT_KW),
                                device="cpu")
    got = tpipe.token_similarity_map(
        model, torch.from_numpy(qimg[0]), torch.from_numpy(frames[2][0]),
        model.cfg, cfg).numpy()
    assert got.shape == want.shape == (4, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class _Painter:
    """A plain-callable imagination: a fixed image group per prompt."""

    def __init__(self, imgs):
        self.imgs = imgs

    def __call__(self, prompt):
        return self.imgs


def _agents(world, **kw):  # noqa: F811
    """The JAX agent after 12 frames, and a port agent holding its store
    and the same weights."""
    cfg, env, frames, _, qimg, params = world
    jcfg = jv.ViTConfig(**VIT_KW)
    painter = _Painter(np.stack([frames[3][0], frames[5][0]]))
    jmem = jsm.VoxelTokenMemory(
        cfg, env, jsm.Perception.create(cfg, jcfg, _jax_params(world),
                                        batch_size=4),
        imagination=painter, **kw)
    for rgb, depth, pose in frames:
        jmem.push_frame({"rgb": rgb, "depth": depth}, pose)
    jmem.flush()
    model = vit_from_jax_params(params, tv.ViTConfig(**VIT_KW),
                                device="cpu")
    tmem = tsm.VoxelTokenMemory(
        cfg, env, tsm.Perception.create(cfg, model.cfg, model, batch_size=4,
                                        device="cpu"),
        imagination=painter, **kw)
    tmem.state = store_from_jax(jmem.state)
    return jmem, tmem


def _same_results(got, want, atol):
    """voxel_localized-shaped tuples equal: the live top-K as a set above
    the K-th score, scores within atol."""
    assert len(got) == len(want)
    for (gb, gp, gs), (wb, wp, ws) in zip(got, want):
        assert len(gs) == len(ws) > 0
        pad = lambda s: np.asarray(s, np.float32)
        assert_same_topk(gp, pad(gs), wp, pad(ws), atol=atol)
        if len(ws) and np.abs(pad(gs)[0] - pad(ws)[0]) > atol:
            raise AssertionError("best scores differ")


def test_voxel_localized_batch_matches_jax_agent(world):  # noqa: F811
    """A group prompt, the same object again (pooled once), one image, a
    text prompt through a plain-callable imagination; radii with inf among
    them around one grid cell; the single-floor mask on: each prompt's
    top-16 as the JAX agent's, within 1e-4."""
    cfg, _, frames, _, qimg, _ = world
    jmem, tmem = _agents(world)
    centre = jmem.voxel_localized(qimg, K=1)[0][0]
    for m in (jmem, tmem):
        m.load_single_floor = True
        m.floor_min_height, m.floor_max_height = centre[2] - 8, centre[2] + 8
    calls = []
    pool = tmem.perception.pool_step
    tmem.perception.pool_step = lambda *a: calls.append(1) or pool(*a)
    group = qimg
    prompts = [group, group, frames[6][0], "a red box"]
    radii = [np.inf, 12.0, np.inf, 20.0]
    want = jmem.voxel_localized_batch(prompts, K=16, region_radii=radii,
                                      curr_grid=centre)
    got = tmem.voxel_localized_batch(prompts, K=16, region_radii=radii,
                                     curr_grid=centre)
    assert len(calls) == 3
    _same_results(got, want, atol=1e-4)
    for (_, pos, _), r in zip(got, radii):
        if np.isfinite(r):
            assert np.all(((pos - centre) ** 2).sum(axis=1) <= r * r)
    # without radii, one per prompt, unrestricted
    _same_results(tmem.voxel_localized_batch(prompts[:3], K=16),
                  jmem.voxel_localized_batch(prompts[:3], K=16), atol=1e-4)
    with pytest.raises(ValueError, match="curr_grid"):
        tmem.voxel_localized_batch(prompts[:1], region_radii=[3.0])


def test_encoder_int8_pool_matches_jax(world):  # noqa: F811
    """``encoder_int8``: the port's quantized leaves equal JAX's
    (``vit.quantize_params``), and the pooled query vector of an image
    group holds JAX's int8 encoder's.  int8 codes agree on equal inputs,
    but the two sides' f32 activations differ by ~1e-6 (and jitted XLA
    divides by 127 as a reciprocal product), which may flip a code that
    sits at a rounding boundary, moving an activation by ~1/254 of its
    row's absmax: the pooled vectors are held within 2e-3 of their max
    |value| and to a cosine of 0.9999 -- while the f32 encoder's pool lies
    ~1e-2 away, so the bound tells the two paths apart."""
    cfg, _, frames, _, qimg, params = world
    qcfg = cfg.replace(models=dataclasses.replace(cfg.models,
                                                  encoder_int8=True))
    # layer scales of 1 (random init has 1e-5), so that the blocks'
    # matmuls reach the pooled vector
    params = jax.tree_util.tree_map(np.array, params)
    for blk in params["blocks"]:
        blk["ls1"][:] = blk["ls2"][:] = 1.0
    jcfg = jv.ViTConfig(**VIT_KW)
    jperc = jsm.Perception.create(
        qcfg, jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    model = vit_from_jax_params(params, tv.ViTConfig(**VIT_KW),
                                device="cpu")
    tperc = tsm.Perception.create(qcfg, model.cfg, model, device="cpu")
    assert tperc.vit_params.quantized and not model.quantized
    for i, blk in enumerate(jperc.vit_params["blocks"]):
        for k in ("qkv", "proj", "fc1", "fc2"):
            leaf = getattr(tperc.vit_params.blocks[i], k)
            assert leaf.w is None
            np.testing.assert_array_equal(leaf.w_q.numpy(),
                                          np.asarray(blk[k]["w_q"]))
            np.testing.assert_array_equal(leaf.w_s.numpy(),
                                          np.asarray(blk[k]["w_s"]))
    want = np.asarray(jperc.pool_step(jperc.vit_params, jnp.asarray(qimg)))
    got = tperc.pool_step(tperc.vit_params, torch.from_numpy(qimg)).numpy()
    f32 = tsm.Perception.create(cfg, model.cfg, model, device="cpu")
    plain = f32.pool_step(model, torch.from_numpy(qimg)).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert np.abs(plain - want).max() > 5e-3 * scale  # the paths differ
    np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=0)
    cos = float(got @ want / np.linalg.norm(got) / np.linalg.norm(want))
    assert cos >= 0.9999, cos
    with pytest.raises(ValueError, match="already quantized"):
        tv.quantize_params(tperc.vit_params)
