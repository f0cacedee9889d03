"""Port parity: geometry helpers and the batched ingest against
bsc_nav_tpu/geometry.py and bsc_nav_tpu/memory/ingest.py.

Integer state must match exactly.  Float rows may differ by a few ulps
(different summation order, the 4x4 inverse of the frame chain computed
by another LU), within 1e-5 relative.  Such ulps could in principle flip
a point that lies within an ulp of a cell edge; none of the seeds used
here has such a point.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu import geometry as JG
from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.memory import ingest as jing
from bsc_nav_tpu.config import Config
from bsc_nav_tpu.memory import store as jstore
from bsc_nav_tpu.memory.store import init_store as jinit
from bsc_nav_tpu_torch import geometry as TG
from bsc_nav_tpu_torch.memory import ingest as ting
from bsc_nav_tpu_torch.memory import store as tstore
from bsc_nav_tpu_torch.memory.store import init_store as tinit

from test_ingest import make_frames
from torch_parity import ingest_draws, store_fields_equal, tensors


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    p = np.zeros((n, 7), np.float32)
    p[:, :3] = rng.uniform(-2, 2, size=(n, 3))
    q = rng.normal(size=(n, 4))
    p[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return p


def test_fixed_transforms_match():
    for f, args in ((JG.camera_intrinsics, (680, 680, 90.0)),
                    (JG.patch_intrinsics, (16, 16)),
                    (JG.base_axes_transform, ()),
                    (JG.base_to_cam_transform, (1.5,))):
        np.testing.assert_array_equal(getattr(TG, f.__name__)(*args),
                                      f(*args))


def test_se3_chain_matches_jax():
    # f32 4x4 products and inverses: 1e-5 abs on O(1) entries
    poses = _poses(5)
    base = JG.base_axes_transform().astype(np.float32)
    b2c = JG.base_to_cam_transform(1.5).astype(np.float32)
    jinv = JG.initial_base_inverse(jnp.asarray(poses[0]), jnp.asarray(base))
    tinv = TG.initial_base_inverse(torch.from_numpy(poses[0]),
                                   torch.from_numpy(base))
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), atol=1e-5)
    np.testing.assert_allclose(
        TG.pose_vec_to_tf(torch.from_numpy(poses)).numpy(),
        np.asarray(JG.pose_vec_to_tf(jnp.asarray(poses))), atol=1e-6)
    want = jax.vmap(lambda p: JG.camera_to_world_transform(
        p, jinv, jnp.asarray(base), jnp.asarray(b2c)))(jnp.asarray(poses))
    got = TG.camera_to_world_transform(torch.from_numpy(poses), tinv,
                                       torch.from_numpy(base),
                                       torch.from_numpy(b2c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_grid_helpers_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-6, 6, size=(4000, 3)).astype(np.float32)
    # on cell edges: k * 0.1 and its float32 neighbours; against the
    # jitted JAX function, as ingest_frames runs it
    k = np.arange(-40, 40, dtype=np.float32) * np.float32(0.1)
    edges = np.concatenate([k, np.nextafter(k, np.float32(-9)),
                            np.nextafter(k, np.float32(9))])
    pts[:edges.size] = np.stack([edges] * 3, axis=-1)
    np.testing.assert_array_equal(
        TG.world_to_grid(torch.from_numpy(pts), 96, 0.1).numpy(),
        np.asarray(jax.jit(JG.world_to_grid, static_argnums=(1, 2))(
            jnp.asarray(pts), 96, 0.1)))
    rc = rng.integers(-5, 110, size=(4000, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        TG.grid_in_range(torch.from_numpy(rc), 96, -32, 32).numpy(),
        np.asarray(JG.grid_in_range(jnp.asarray(rc), 96, -32, 32)))
    pts[:, 2] = np.abs(pts[:, 2]) + 0.1
    intr = JG.patch_intrinsics(16, 16).astype(np.float32)
    jp = JG.project_points(jnp.asarray(intr), jnp.asarray(pts))
    tp = TG.project_points(torch.from_numpy(intr), torch.from_numpy(pts))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ingest_both(cfg, batches, key_seed):
    """Ingest the same frame batches into a JAX and a port store, the
    port with the JAX draws injected."""
    js, ts = jinit(cfg.memory), tinit(cfg.memory)
    key = jax.random.PRNGKey(key_seed)
    for rgb, depth, poses, tokens in batches:
        key, sub = jax.random.split(key)
        js, _ = jing.ingest_frames(js, *map(jnp.asarray,
                                            (rgb, depth, poses, tokens)),
                                   sub, cfg)
        pix, repl = ingest_draws(sub, cfg, rgb.shape[0])
        ts, stats = ting.ingest_frames(
            ts, *tensors(rgb, depth, poses, tokens), None, cfg,
            pix=torch.from_numpy(pix), repl_idx=torch.from_numpy(repl))
    return js, ts, stats


def _float_rows_close(js, ts, cfg):
    m = cfg.memory
    V, K = m.voxel_capacity, m.cache_size
    for f, rows in (("feats", V * K), ("feat_norm", V * K),
                    ("feat_dist", V * K), ("rgb_sum", V), ("weight", V)):
        np.testing.assert_allclose(getattr(ts, f).numpy()[:rows],
                                   np.asarray(getattr(js, f))[:rows],
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("n_batches,B,seed", [(1, 3, 0), (3, 2, 5)])
def test_ingest_matches_jax(n_batches, B, seed):
    cfg = small_test_config()
    batches = [make_frames(cfg, B, seed=seed + i) for i in range(n_batches)]
    js, ts, stats = _ingest_both(cfg, batches, key_seed=42 + seed)
    assert int(ts.num_voxels) > 50
    store_fields_equal(js, ts, cfg)
    _float_rows_close(js, ts, cfg)
    assert int(stats["num_voxels"]) == int(js.num_voxels)


def test_capacity_overflow_matches_jax():
    cfg = small_test_config()
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory,
                                                 voxel_capacity=40))
    js, ts, stats = _ingest_both(cfg, [make_frames(cfg, 2, seed=9)], 1)
    assert int(ts.dropped_voxels) > 0 and int(ts.num_voxels) == 40
    store_fields_equal(js, ts, cfg)
    _float_rows_close(js, ts, cfg)


def test_store_helpers_match_jax():
    for cfg in (small_test_config(), Config()):
        assert tstore.padded_rows(cfg.memory) == jstore.padded_rows(
            cfg.memory)
        for jd, td in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
            assert (tstore.store_nbytes(cfg.memory, td)
                    == jstore.store_nbytes(cfg.memory, jd))
    cfg = small_test_config()
    js, ts, _ = _ingest_both(cfg, [make_frames(cfg, 2, seed=3)], 2)
    V = cfg.memory.voxel_capacity
    # fused_rgb truncates to uint8, so the ulps by which the two ingests'
    # rgb_sum / weight differ (see _float_rows_close) can flip a channel
    # by 1: hold the function itself to JAX's on the same sums, exactly
    sums = dataclasses.replace(
        ts, rgb_sum=torch.from_numpy(np.array(js.rgb_sum)),
        weight=torch.from_numpy(np.array(js.weight)))
    np.testing.assert_array_equal(tstore.fused_rgb(sums).numpy()[:V],
                                  np.asarray(jstore.fused_rgb(js))[:V])
    (tp, tv), (jp, jv) = (tstore.occupied_positions(ts),
                          jstore.occupied_positions(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy()[:V], np.asarray(jp)[:V])
    rc = np.random.default_rng(0).integers(0, 64, size=(50, 3))
    np.testing.assert_array_equal(
        tstore.linear_voxel_id(torch.from_numpy(rc), 64, 64).numpy(),
        np.asarray(jstore.linear_voxel_id(jnp.asarray(rc), 64, 64)))


def test_golden_digest():
    """tests/test_golden.py's pinned digest, reproduced by the port from
    the same frames and the JAX draws of PRNGKey(123)."""
    cfg = small_test_config()
    rgb, depth, poses, tokens = make_frames(cfg, 2, seed=123)
    pix, repl = ingest_draws(jax.random.PRNGKey(123), cfg, 2)
    state, _ = ting.ingest_frames(
        tinit(cfg.memory), *tensors(rgb, depth, poses, tokens), None, cfg,
        pix=torch.from_numpy(pix), repl_idx=torch.from_numpy(repl))
    n = int(state.num_voxels)
    digest = {
        "num_voxels": n,
        "pos_sum": int(state.slot_pos[:n].to(torch.int64).sum()),
        "count_sum": int(state.feat_count[:n].sum()),
        "weight_sum": round(float(state.weight[:n].sum()), 3),
        "max_height_occupied": int((state.max_height >= 0).sum()),
    }
    assert digest == {"num_voxels": 732, "pos_sum": 59852, "count_sum": 806,
                      "weight_sum": 154.392, "max_height_occupied": 574}


def test_generator_draws_are_seeded():
    cfg = small_test_config()
    frames = tensors(*make_frames(cfg, 2, seed=4))
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        state, _ = ting.ingest_frames(tinit(cfg.memory), *frames, gen, cfg)
        runs.append(state)
    assert int(runs[0].num_voxels) > 50
    m = cfg.memory
    live = {"slot_pos": m.voxel_capacity, "feat_count": m.voxel_capacity,
            "feats": m.voxel_capacity * m.cache_size,
            "cv_map": m.grid_size ** 2}         # garbage rows excluded
    for f, n in live.items():
        assert torch.equal(getattr(runs[0], f)[:n], getattr(runs[1], f)[:n])


def test_surprise_policy_not_ported():
    cfg = small_test_config()
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory,
                                                 replacement="surprise"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tinit(cfg.memory)
