"""Port parity: the int8 store -- ``init_store(..., int8)``,
``quantize_feat_rows``, ``quantize_store``, ``token_cache_view``,
``dequantized_feats``, ``store_nbytes`` (bsc_nav_tpu/memory/store.py) --
the int8 write branch of the ingest (bsc_nav_tpu/memory/ingest.py:352-
362) and a query over an int8 store (memory/query.py).

int8 codes are compared byte for byte.  A code may differ by 1 only where
the quotient f / scale lies within one f32 ulp of a half, where the last
bit of the division decides the rounding; scales and int8-row norms are
compared to the bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.config import Config, small_test_config
from bsc_nav_tpu.memory import ingest as jing
from bsc_nav_tpu.memory import query as jq
from bsc_nav_tpu.memory import store as jstore
from bsc_nav_tpu_torch.memory import ingest as ting
from bsc_nav_tpu_torch.memory import query as tq
from bsc_nav_tpu_torch.memory import store as tstore

from test_ingest import make_frames
from torch_parity import (assert_same_topk, ingest_draws, store_fields_equal,
                          store_from_jax, tensors)


def assert_codes_equal(got, want, f, scale):
    """int8 codes equal, but where f / scale is within one f32 ulp of a
    half: there the two may differ by 1."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    diff = got - want
    assert np.abs(diff).max(initial=0) <= 1, "codes differ by more than 1"
    rows, cols = np.nonzero(diff)
    if len(rows):
        quot = np.abs(np.float64(f[rows, cols]) / np.float64(scale[rows]))
        ulp = np.spacing(np.float32(quot)).astype(np.float64)
        near = np.abs(quot - np.floor(quot) - 0.5) <= ulp
        assert near.all(), (f"{int((~near).sum())} codes differ away "
                            "from a half")


def _rows(seed, n=300, D=48):
    """Token rows over many magnitudes, with zero rows, rows whose absmax
    is 127 (scale exactly 1, so quotients k + 0.5 are exact ties) and
    never-written rows (norm 0)."""
    rng = np.random.default_rng(seed)
    f = (rng.normal(size=(n, D)) * rng.uniform(1e-3, 50, size=(n, 1))
         ).astype(np.float32)
    f[:5] = 0.0
    f[5:15] = rng.integers(-254, 255, size=(10, D)) / np.float32(2.0)
    f[5:15, 0] = 127.0
    norms = np.linalg.norm(f, axis=1).astype(np.float32)
    norms[::7] = 0.0
    return f, norms


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_feat_rows_matches_jax(seed):
    f, norms = _rows(seed)
    jq_, jn, js = map(np.asarray, jstore.quantize_feat_rows(
        jnp.asarray(f), jnp.asarray(norms)))
    tq_, tn, ts = (a.numpy() for a in tstore.quantize_feat_rows(
        torch.from_numpy(f), torch.from_numpy(norms)))
    assert tq_.dtype == np.int8
    np.testing.assert_array_equal(ts, js)
    assert_codes_equal(tq_, jq_, f, js)
    np.testing.assert_array_equal(tn, jn)
    # the exact ties round to even on both sides
    tie = f[5:15] != np.round(f[5:15])
    assert tie.any() and np.all(np.abs(tq_[5:15][tie]) % 2 == 0)


def test_init_store_int8_layout_matches_jax():
    for cfg in (small_test_config(), Config()):
        assert (tstore.store_nbytes(cfg.memory, torch.int8)
                == jstore.store_nbytes(cfg.memory, jnp.int8))
    cfg = small_test_config()
    js = jstore.init_store(cfg.memory, jnp.int8)
    ts = tstore.init_store(cfg.memory, torch.int8, device="cpu")
    for name in tstore.VoxelStoreState.__dataclass_fields__:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _ingest_both(cfg, batches, key_seed, jdtype, tdtype):
    js = jstore.init_store(cfg.memory, jdtype)
    ts = tstore.init_store(cfg.memory, tdtype, device="cpu")
    key = jax.random.PRNGKey(key_seed)
    for rgb, depth, poses, tokens in batches:
        key, sub = jax.random.split(key)
        js, _ = jing.ingest_frames(js, *map(jnp.asarray,
                                            (rgb, depth, poses, tokens)),
                                   sub, cfg)
        pix, repl = ingest_draws(sub, cfg, rgb.shape[0])
        ts, _ = ting.ingest_frames(
            ts, *tensors(rgb, depth, poses, tokens), None, cfg,
            pix=torch.from_numpy(pix), repl_idx=torch.from_numpy(repl))
    return js, ts


def _written(state, cfg):
    """Mask [V*K] of the rows below each slot's count."""
    m = cfg.memory
    V, K = m.voxel_capacity, m.cache_size
    count = state.feat_count[:V].numpy()
    return (np.arange(K)[None, :] < count[:, None]).reshape(V * K)


@pytest.fixture(scope="module")
def int8_stores():
    """Three batches of frames into int8 stores (JAX and port, the JAX
    draws injected), and the same into f32 port stores."""
    cfg = small_test_config()
    batches = [make_frames(cfg, 2, seed=30 + i) for i in range(3)]
    js, ts = _ingest_both(cfg, batches, 8, jnp.int8, torch.int8)
    jf, tf = _ingest_both(cfg, batches, 8, jnp.float32, torch.float32)
    return cfg, js, ts, jf, tf


def test_int8_ingest_matches_jax(int8_stores):
    """Equal integer store; over the written rows the codes byte for byte
    (the half-ulp rule), scales and int8-row norms to the bit."""
    cfg, js, ts, _, tf = int8_stores
    assert int(ts.num_voxels) > 100
    store_fields_equal(js, ts, cfg)
    w = _written(ts, cfg)
    V, K = cfg.memory.voxel_capacity, cfg.memory.cache_size
    jscale = np.asarray(js.feat_scale)[:V * K][w]
    np.testing.assert_array_equal(ts.feat_scale.numpy()[:V * K][w], jscale)
    np.testing.assert_array_equal(ts.feat_norm.numpy()[:V * K][w],
                                  np.asarray(js.feat_norm)[:V * K][w])
    assert_codes_equal(ts.feats.numpy()[:V * K][w],
                       np.asarray(js.feats)[:V * K][w],
                       tf.feats.numpy()[:V * K][w], jscale)


def test_int8_ingest_equals_quantize_store_of_the_f32_store(int8_stores):
    """One formula: the int8 ingest gives, over the written rows, exactly
    what ``quantize_store`` makes of the f32 store from the same frames;
    ``quantize_store`` itself matches JAX's on that store."""
    cfg, js, ts, jf, tf = int8_stores
    q = tstore.quantize_store(tf)
    assert q.feats.dtype == torch.int8 and q.slot_pos is tf.slot_pos
    assert tstore.quantize_store(q) is q
    w = _written(ts, cfg)
    V, K = cfg.memory.voxel_capacity, cfg.memory.cache_size
    for f in ("feats", "feat_scale", "feat_norm"):
        np.testing.assert_array_equal(getattr(q, f).numpy()[:V * K][w],
                                      getattr(ts, f).numpy()[:V * K][w],
                                      err_msg=f)
    jqs = jstore.quantize_store(jf)
    np.testing.assert_array_equal(q.feat_scale.numpy()[:V * K],
                                  np.asarray(jqs.feat_scale)[:V * K])
    np.testing.assert_array_equal(q.feat_norm.numpy()[:V * K],
                                  np.asarray(jqs.feat_norm)[:V * K])
    assert_codes_equal(q.feats.numpy()[:V * K],
                       np.asarray(jqs.feats)[:V * K],
                       tf.feats.numpy()[:V * K],
                       np.asarray(jqs.feat_scale)[:V * K])


def test_views_match_jax(int8_stores):
    """token_cache_view and dequantized_feats (int8: codes times scales,
    one f32 product each) equal JAX's on JAX's store arrays."""
    cfg, js, _, jf, _ = int8_stores
    for jstate in (js, jf):
        t = store_from_jax(jstate)
        for a, b in zip(tstore.token_cache_view(t),
                        jstore.token_cache_view(jstate)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            tstore.dequantized_feats(t).numpy(),
            np.asarray(jstore.dequantized_feats(jstate)))


@pytest.mark.parametrize("masks", [{}, {"use_floor": True}])
def test_localize_on_int8_store_matches_jax(int8_stores, masks):
    """The single-query scan of an int8 store (bf16-rounded query, codes
    widened exactly): top-K sets equal, scores within 1e-5."""
    cfg, js, _, _, _ = int8_stores
    ts = store_from_jax(js)
    rng = np.random.default_rng(3)
    q = rng.normal(size=cfg.memory.token_dim).astype(np.float32)
    n = int(ts.num_voxels)
    heights = ts.slot_pos[:n, 2].numpy()
    floor = np.asarray([np.percentile(heights, 20),
                        np.percentile(heights, 80)], np.int32)
    jpos, jsc = jq.localize(js, jnp.asarray(q), top_k=32,
                            floor_range=jnp.asarray(floor), **masks)
    tpos, tsc = tq.localize(ts, torch.from_numpy(q), top_k=32,
                            floor_range=torch.from_numpy(floor), **masks)
    assert np.isfinite(tsc.numpy()).all()
    assert_same_topk(tpos.numpy(), tsc.numpy(), jpos, jsc, atol=1e-5)
