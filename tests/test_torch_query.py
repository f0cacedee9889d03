"""Port parity: query pooling and localization (region and floor masks,
top-K) against bsc_nav_tpu/memory/query.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.memory import ingest as jing
from bsc_nav_tpu.memory import query as jq
from bsc_nav_tpu.memory.store import init_store as jinit
from bsc_nav_tpu_torch.memory import ingest as ting
from bsc_nav_tpu_torch.memory import query as tq
from bsc_nav_tpu_torch.memory.store import init_store as tinit

from test_ingest import make_frames
from torch_parity import assert_same_topk, ingest_draws, tensors


@pytest.fixture(scope="module")
def stores():
    cfg = small_test_config()
    rgb, depth, poses, tokens = make_frames(cfg, 4, seed=7)
    key = jax.random.PRNGKey(3)
    js, _ = jing.ingest_frames(jinit(cfg.memory),
                               *map(jnp.asarray, (rgb, depth, poses, tokens)),
                               key, cfg)
    pix, repl = ingest_draws(key, cfg, 4)
    ts, _ = ting.ingest_frames(
        tinit(cfg.memory, device="cpu"),
        *tensors(rgb, depth, poses, tokens), None, cfg,
        pix=torch.from_numpy(pix), repl_idx=torch.from_numpy(repl))
    # make_frames has 4 distinct tokens per frame, so per-voxel scores
    # tie massively; distinct random rows make the top-K well defined
    rng = np.random.default_rng(5)
    feats = rng.normal(size=ts.feats.shape).astype(np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    js = js.replace(feats=jnp.asarray(feats), feat_norm=jnp.asarray(norms))
    ts.feats.copy_(torch.from_numpy(feats))
    ts.feat_norm.copy_(torch.from_numpy(norms))
    return cfg, js, ts


def test_gaussian_center_pool_matches_jax():
    tok = np.random.default_rng(0).normal(size=(3, 16, 24)).astype(
        np.float32)
    want = np.asarray(jq.gaussian_center_pool(jnp.asarray(tok)))
    got = tq.gaussian_center_pool(torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("masks", [
    {},
    {"use_region": True, "region_radius": 9.0},
    {"use_floor": True},
    {"use_region": True, "region_radius": 14.0, "use_floor": True},
])
def test_localize_matches_jax(stores, masks):
    """Top-K voxel sets equal; scores within 1e-5 (f32 dots summed in
    another order); -inf padding identical."""
    cfg, js, ts = stores
    n = int(ts.num_voxels)
    assert n > 100
    rng = np.random.default_rng(1)
    q = rng.normal(size=cfg.memory.token_dim).astype(np.float32)
    grid = np.asarray(ts.slot_pos[n // 2].numpy(), np.int32)
    heights = ts.slot_pos[:n, 2].numpy()
    floor = np.asarray([np.percentile(heights, 25),
                        np.percentile(heights, 75)], np.int32)
    kw = dict(masks)
    jkw = dict(kw, curr_grid=jnp.asarray(grid), floor_range=jnp.asarray(floor))
    tkw = dict(kw, curr_grid=torch.from_numpy(grid),
               floor_range=torch.from_numpy(floor))
    top_k = 64
    jpos, jsc = jq.localize(js, jnp.asarray(q), top_k=top_k, **jkw)
    tpos, tsc = tq.localize(ts, torch.from_numpy(q), top_k=top_k, **tkw)
    assert np.isfinite(tsc.numpy()).sum() > 5
    assert_same_topk(tpos.numpy(), tsc.numpy(), jpos, jsc, atol=1e-5)
