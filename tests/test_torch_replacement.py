"""Port parity: the surprise replacement policy of the ingest (both modes;
bsc_nav_tpu/memory/ingest.py:239-306, :324-335), its store statistics
(memory/store.py:121-124, their ``.npz`` round trip) and the forgetting
pass (memory/replacement.py), against the JAX package on the CPU, in f32,
bf16 and int8 stores.

Integer state must be equal.  It rests on decisions taken on f32
cosines, which the two packages sum in different orders: each test
checks that every decision it relies on lies farther than ``MARGIN``
from flipping -- the surprise gate from its threshold, the most-similar
row from the next distinct row, the forgetting pass's pairs from its
threshold -- which bounds the cosines' difference (an f32 dot of D = 32
terms is within gamma_33 ~ 2e-6 of exact, the running sums reassociated
within a few ulps) with room to spare.  Float rows are compared within
1e-5 relative (1e-6 absolute); int8 codes exactly on equal inputs, and
after the forgetting pass within 1 with scales at 1e-6 relative.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu.memory import ingest as jing
from bsc_nav_tpu.memory import persistence as jp
from bsc_nav_tpu.memory import replacement as jrep
from bsc_nav_tpu.memory import store as jstore
from bsc_nav_tpu_torch import full_f32_matmul
from bsc_nav_tpu_torch.memory import ingest as ting
from bsc_nav_tpu_torch.memory import persistence as tp
from bsc_nav_tpu_torch.memory import replacement as trep
from bsc_nav_tpu_torch.memory import store as tstore

from test_ingest import make_frames
from test_replacement import oracle_forgetting
from test_torch_persistence import assert_stores_equal, to_port
from torch_parity import ingest_draws, store_fields_equal, tensors

MARGIN = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def surprise_cfg(exact=False, threshold=0.5):
    """tests/test_replacement.py's surprise config: 64^2 grid, K 4, D 32."""
    cfg = small_test_config()
    return cfg.replace(memory=dataclasses.replace(
        cfg.memory, voxel_capacity=(1 << 10) - 8, replacement="surprise",
        surprise_exact=exact, surprise_threshold=threshold))


def revisit_batches(cfg, seed=0):
    """Three batches over the same two frames (constant depth 0.5 m at
    the origin, so voxels are revisited densely): the frames' tokens;
    then the top patch row's tokens moved by noise (not novel) and the
    bottom row's fresh (novel); then the first tokens again."""
    rgb, depth, poses, tokens = make_frames(cfg, 2, seed=seed)
    depth[:] = 0.5
    poses[:, :3] = 0.0
    poses[:, 3:6] = 0.0
    poses[:, 6] = 1.0
    rng = np.random.default_rng(seed + 1)
    moved = tokens + 0.5 * rng.normal(size=tokens.shape)
    moved[:, 1] = rng.normal(size=moved[:, 1].shape)
    return [(rgb, depth, poses, t.astype(np.float32))
            for t in (tokens, moved, tokens)]


def moving_batches(cfg):
    """Three frames at random poses and depths, twice: the tokens, then
    the tokens moved by noise."""
    rgb, depth, poses, tokens = make_frames(cfg, 3, seed=20)
    moved = tokens + np.random.default_rng(21).normal(
        size=tokens.shape).astype(np.float32)
    return [(rgb, depth, poses, tokens), (rgb, depth, poses, moved)]


class Decisions:
    """Wraps the port's surprise gate and most-similar row, holding each
    decision the ingest takes to ``MARGIN``: counts what was judged,
    gated out and liable to replacement."""

    def __init__(self, monkeypatch, threshold):
        self.threshold = threshold
        self.judged = self.gated = self.full = 0
        gate, row = ting._surprise, ting._most_similar

        def surprise(state, token, tok_norm, nslot, n_ok, judged, mem):
            novel = gate(state, token, tok_norm, nslot, n_ok, judged, mem)
            v = novel[judged].double().numpy()
            fin = v[np.isfinite(v)]
            gap = np.abs(fin - threshold).min(initial=np.inf)
            assert gap > MARGIN, f"a gate within {gap:.2g} of its threshold"
            self.judged += int(judged.sum())
            self.gated += int((v <= threshold).sum())
            return novel

        def most_similar(state, slot_g, token, tok_norm, K):
            out = row(state, slot_g, token, tok_norm, K)
            self._check_rows(state, slot_g, token, K)
            return out

        monkeypatch.setattr(ting, "_surprise", surprise)
        monkeypatch.setattr(ting, "_most_similar", most_similar)

    def _check_rows(self, state, slot_g, token, K):
        """Where several cached rows come within MARGIN of the best cosine,
        they must be the same row (equal rows give equal cosines, and the
        first wins in both packages)."""
        V = state.feat_count.shape[0]
        feats = state.feats.float().double().numpy()
        norms = state.feat_norm.double().numpy()
        counts = state.feat_count.numpy()
        tok = token.double().numpy()
        tn = np.linalg.norm(tok, axis=1)
        for i, s in enumerate(slot_g.numpy()):
            c = counts[s] if s < V else 0
            if c == 0:
                continue
            self.full += int(c == K)
            r = feats[s * K:s * K + c]
            cos = r @ tok[i] / np.maximum(norms[s * K:s * K + c] * tn[i],
                                          1e-12)
            near = np.flatnonzero(cos >= cos.max() - MARGIN)
            for j in near[1:]:
                assert np.array_equal(r[j], r[near[0]]), (
                    f"point {i}: distinct rows within {MARGIN} of the best")


def _ingest_both(cfg, dtype, batches, key_seed=0):
    jd, td = DTYPES[dtype]
    js = jstore.init_store(cfg.memory, jd)
    ts = tstore.init_store(cfg.memory, td, device="cpu")
    key = jax.random.PRNGKey(key_seed)
    stats = []
    for rgb, depth, poses, tokens in batches:
        key, sub = jax.random.split(key)
        js, _ = jing.ingest_frames(js, *map(jnp.asarray,
                                            (rgb, depth, poses, tokens)),
                                   sub, cfg)
        pix, _ = ingest_draws(sub, cfg, rgb.shape[0])
        ts, st = ting.ingest_frames(ts, *tensors(rgb, depth, poses, tokens),
                                    None, cfg, pix=torch.from_numpy(pix))
        stats.append(st)
    return js, ts, stats


def _float(a):
    a = a.float() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.asarray(a, np.float32)


def assert_surprise_stores_match(js, ts, cfg):
    store_fields_equal(js, ts, cfg)
    m = cfg.memory
    n = int(js.num_voxels)
    K = m.cache_size
    for f, rows in (("feats", n * K), ("feat_norm", n * K),
                    ("feat_dist", n * K), ("rgb_sum", n), ("weight", n),
                    ("feat_sum", n)):
        np.testing.assert_allclose(_float(getattr(ts, f))[:rows],
                                   _float(getattr(js, f))[:rows],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    if ts.feats.dtype == torch.int8:
        np.testing.assert_array_equal(ts.feats[:n * K].numpy(),
                                      np.asarray(js.feats)[:n * K])
        np.testing.assert_allclose(ts.feat_scale[:n * K].numpy(),
                                   np.asarray(js.feat_scale)[:n * K],
                                   rtol=1e-6)
    # observation counts are sums of ones: exact
    np.testing.assert_array_equal(ts.feat_obs[:n].numpy(),
                                  np.asarray(js.feat_obs)[:n])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("exact", [False, True], ids=["mean", "exact"])
def test_surprise_ingest_matches_jax(monkeypatch, exact, dtype):
    """Three batches revisiting the same voxels, JAX's pixel draws
    injected: the integer store (slots, counts, maps) equal to JAX's, the
    rows, norms, scales and running sums within their tolerance; some
    points gated out, some full caches replaced by their most similar
    row; the running counts sum to the valid points."""
    cfg = surprise_cfg(exact)
    d = Decisions(monkeypatch, cfg.memory.surprise_threshold)
    js, ts, stats = _ingest_both(cfg, dtype, revisit_batches(cfg))
    assert_surprise_stores_match(js, ts, cfg)
    assert d.judged > 500 and 0 < d.gated < d.judged and d.full > 100
    valid = sum(int(s["points_valid"]) for s in stats)
    cached = sum(int(s["points_cached"]) for s in stats)
    assert cached < valid
    assert float(ts.feat_obs.sum()) == valid
    assert int(ts.feat_count.max()) <= cfg.memory.cache_size


@pytest.mark.parametrize("exact", [False, True], ids=["mean", "exact"])
def test_surprise_on_moving_frames_matches_jax(monkeypatch, exact):
    """Three frames at random poses and depths, ingested twice (other
    pixel draws, the tokens moved by noise): points whose pixel was drawn
    before revisit their voxel, the others land beside old voxels or in
    new ones; a gate threshold of 0.9 for a mix of outcomes."""
    cfg = surprise_cfg(exact, threshold=0.9)
    d = Decisions(monkeypatch, cfg.memory.surprise_threshold)
    js, ts, _ = _ingest_both(cfg, "float32", moving_batches(cfg),
                             key_seed=5)
    assert_surprise_stores_match(js, ts, cfg)
    assert d.judged > 50 and 0 < d.gated < d.judged


@pytest.mark.parametrize("fault", ["all_points_judged", "least_similar"])
def test_surprise_check_catches_a_fault(monkeypatch, fault):
    """The check fails a wrong gate (the points of this batch's new voxels
    judged as well) and a wrong replacement row (the least similar)."""
    cfg = surprise_cfg(threshold=0.9 if fault == "all_points_judged"
                       else 0.5)
    if fault == "all_points_judged":
        gate = ting._surprise
        monkeypatch.setattr(
            ting, "_surprise", lambda s, t, n, ns, ok, judged, m: gate(
                s, t, n, ns, ok, torch.ones_like(judged), m))
    else:
        def least(state, slot_g, token, tok_norm, K):
            rows = slot_g[:, None] * K + torch.arange(K)
            csim = ting._cos_rows(state.feats[rows], token)
            live = torch.arange(K) < state.feat_count[slot_g][:, None]
            return torch.where(live, csim, float("inf")).argmin(dim=-1)
        monkeypatch.setattr(ting, "_most_similar", least)
    batches = (moving_batches(cfg) if fault == "all_points_judged"
               else revisit_batches(cfg))
    js, ts, _ = _ingest_both(cfg, "float32", batches, key_seed=5)
    with pytest.raises(AssertionError):
        assert_surprise_stores_match(js, ts, cfg)


def test_surprise_store_layout_and_dist_unchanged():
    """init_store sizes the running statistics [V1, D] / [V1] under the
    surprise policy and [1, D] / [1] under dist, as JAX's; it refuses an
    unknown policy, and allocates on the card unless told otherwise."""
    for cfg in (surprise_cfg(), small_test_config()):
        js = jstore.init_store(cfg.memory)
        ts = tstore.init_store(cfg.memory, device="cpu")
        for f in ("feat_sum", "feat_obs"):
            assert tuple(getattr(ts, f).shape) == getattr(js, f).shape, f
            assert getattr(ts, f).dtype == torch.float32
    with pytest.raises(ValueError, match="replacement"):
        tstore.init_store(dataclasses.replace(surprise_cfg().memory,
                                              replacement="lru"),
                          device="cpu")
    if not torch.cuda.is_available():        # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            tstore.init_store(surprise_cfg().memory)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_surprise_npz_both_ways(tmp_path, dtype):
    """A surprise store's snapshot (statistics included) written by either
    package holds the same arrays under the same keys and loads equal in
    the other."""
    cfg = surprise_cfg()
    jd, td = DTYPES[dtype]
    js, _, _ = _ingest_both(cfg, dtype, revisit_batches(cfg)[:2])
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    jp.save_npz(js, jpath)
    tp.save_npz(to_port(js), tpath)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["feat_sum"].shape[0] == int(js.num_voxels) + 1
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_stores_equal(tp.load_npz(jpath, cfg.memory, store_dtype=td,
                                    device="cpu"),
                        jp.load_npz(jpath, cfg.memory, store_dtype=jd))
    assert_stores_equal(to_port(jp.load_npz(tpath, cfg.memory,
                                            store_dtype=jd)),
                        jp.load_npz(jpath, cfg.memory, store_dtype=jd))


# ---------------------------------------------------------------------------
# the forgetting pass
# ---------------------------------------------------------------------------

def _dup_store(dtype, seed=0):
    """A JAX dist store with near-duplicate caches: 2 x 2 patch tokens a
    frame, so a voxel's points often share a token; half the tokens of
    the second batch are the first's moved by 1e-3 (cosine ~1), the rest
    fresh."""
    cfg = small_test_config()
    jd, _ = DTYPES[dtype]
    rgb, depth, poses, tokens = make_frames(cfg, 2, seed=seed)
    rng = np.random.default_rng(seed + 7)
    t2 = tokens + 1e-3 * rng.normal(size=tokens.shape).astype(np.float32)
    t2[:, 0] = rng.normal(size=t2[:, 0].shape)
    s = jstore.init_store(cfg.memory, jd)
    key = jax.random.PRNGKey(seed)
    for tk in (tokens, t2):
        key, sub = jax.random.split(key)
        s, _ = jing.ingest_frames(s, *map(jnp.asarray,
                                          (rgb, depth, poses, tk)), sub, cfg)
    return cfg, s


def assert_pairs_clear_threshold(state, threshold):
    """Every pair of live rows' cosine (f64, on the stored rows) lies
    farther than MARGIN from the threshold."""
    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1
    f = _float(state.feats).astype(np.float64).reshape(V1, K, -1)
    n = np.asarray(state.feat_norm, np.float64).reshape(V1, K)
    c = np.asarray(state.feat_count)
    worst = np.inf
    for v in np.flatnonzero(c > 1):
        k = c[v]
        sims = f[v, :k] @ f[v, :k].T / np.maximum(
            n[v, :k, None] * n[v, None, :k], 1e-12)
        off = sims[~np.eye(k, dtype=bool)]
        worst = min(worst, np.abs(off - threshold).min())
    assert worst > MARGIN, f"a pair within {worst:.2g} of the threshold"


def assert_forgotten_equal(ts, js):
    """Counts exact, every other field over all V1 x K rows: f32 / bf16
    rows, norms and distances within 1e-5 relative; int8 codes within 1,
    scales within 1e-6 relative (1.0 on every row past a count)."""
    np.testing.assert_array_equal(ts.feat_count.numpy(),
                                  np.asarray(js.feat_count))
    if ts.feats.dtype == torch.int8:
        diff = ts.feats.numpy().astype(np.int32) - np.asarray(
            js.feats).astype(np.int32)
        assert np.abs(diff).max() <= 1
        np.testing.assert_allclose(ts.feat_scale.numpy(),
                                   np.asarray(js.feat_scale), rtol=1e-6)
    else:
        np.testing.assert_allclose(_float(ts.feats), _float(js.feats),
                                   rtol=1e-5, atol=1e-6)
    for f in ("feat_norm", "feat_dist"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forgetting_pass_matches_jax(dtype):
    """A store with merges in many voxels: the same counts and rows as
    JAX's pass, field for field over every row (the rows past each count
    zeroed, int8 scales 1.0 there, as JAX's pass over all V1 voxels
    leaves them)."""
    cfg, js = _dup_store(dtype)
    assert_pairs_clear_threshold(js, 0.95)
    before = np.asarray(js.feat_count)
    ts = trep.forgetting_pass(to_port(js), threshold=0.95)
    out = jrep.forgetting_pass(js, threshold=0.95)
    assert_forgotten_equal(ts, out)
    after = ts.feat_count.numpy()
    assert (after < before).sum() > 50 and (after == before).sum() > 50
    if dtype == "int8":
        assert (ts.feat_scale.numpy() == 1.0).sum() > 0


def test_forgetting_pass_in_chunks(monkeypatch):
    """Chunks of 7 voxels give the one-chunk result exactly."""
    _, js = _dup_store("float32", seed=3)
    whole = trep.forgetting_pass(to_port(js))
    monkeypatch.setattr(trep, "CHUNK_ELEMENTS",
                        7 * js.feats.shape[0] // js.feat_count.shape[0]
                        * js.feats.shape[1])
    chunked = trep.forgetting_pass(to_port(js))
    for f in ("feats", "feat_norm", "feat_dist", "feat_count"):
        assert torch.equal(getattr(whole, f), getattr(chunked, f)), f


def test_forgetting_pass_matches_oracle():
    """tests/test_replacement.py's union-find oracle: two near-duplicate
    pairs merge to their means, distinct tokens stay."""
    cfg = small_test_config()
    K, D = cfg.memory.cache_size, cfg.memory.token_dim
    rng = np.random.default_rng(0)
    state = tstore.init_store(cfg.memory, device="cpu")
    base = rng.normal(size=(2, D)).astype(np.float32)
    v0 = np.stack([base[0], base[0] * 1.001, base[1], base[1] * 0.999])
    v1 = rng.normal(size=(K, D)).astype(np.float32)
    V1 = state.feat_count.shape[0]
    state.feats.view(V1, K, D)[0, :4] = torch.from_numpy(v0)
    state.feats.view(V1, K, D)[1] = torch.from_numpy(v1)
    state.feat_norm.copy_(torch.linalg.vector_norm(state.feats, dim=-1))
    state.feat_dist.view(V1, K)[0] = torch.tensor([1., 2., 3., 4.])
    state.feat_dist.view(V1, K)[1] = torch.arange(K, dtype=torch.float32)
    state.feat_count[:2] = torch.tensor([4, K], dtype=torch.int32)
    state.num_voxels.fill_(2)
    out = trep.forgetting_pass(state, threshold=0.95)
    ef, ed = oracle_forgetting(v0, np.array([1., 2., 3., 4.]), 4, 0.95)
    assert int(out.feat_count[0]) == len(ef) == 2
    np.testing.assert_allclose(out.feats.view(V1, K, D)[0, :2].numpy(), ef,
                               rtol=1e-5)
    np.testing.assert_allclose(out.feat_dist.view(V1, K)[0, :2].numpy(), ed,
                               rtol=1e-5)
    assert int(out.feat_count[1]) == K
    np.testing.assert_allclose(out.feats.view(V1, K, D)[1].numpy(), v1,
                               rtol=1e-5)


def test_forgetting_int8_uses_dequantized_means():
    """int8: two codes of one direction at scales 100x apart merge to the
    dequantized mean with a fresh scale (JAX's int8 test), equal to JAX."""
    cfg = small_test_config()
    K, D = cfg.memory.cache_size, cfg.memory.token_dim
    js = jstore.init_store(cfg.memory, store_dtype=jnp.int8)
    V1 = js.feat_count.shape[0]
    base = np.random.default_rng(1).normal(size=(D,)).astype(np.float32)
    q = np.zeros((V1, K, D), np.int8)
    scales = np.zeros((V1, K), np.float32)
    for j, f in enumerate((base * 0.1, base * 10.0)):
        scales[0, j] = np.abs(f).max() / 127.0
        q[0, j] = np.clip(np.round(f / scales[0, j]), -127, 127)
    counts = np.zeros((V1,), np.int32)
    counts[0] = 2
    js = js.replace(
        feats=jnp.asarray(q.reshape(V1 * K, D)),
        feat_scale=jnp.asarray(scales.reshape(V1 * K)),
        feat_norm=jnp.asarray(np.linalg.norm(q.astype(np.float32),
                                             axis=-1).reshape(V1 * K)),
        feat_count=jnp.asarray(counts))
    ts = trep.forgetting_pass(to_port(js), threshold=0.95)
    assert_forgotten_equal(ts, jrep.forgetting_pass(js, threshold=0.95))
    assert int(ts.feat_count[0]) == 1
    merged = ts.feats[:D].float() * ts.feat_scale[0]
    want = (base * 0.1 + base * 10.0) / 2
    np.testing.assert_allclose(merged[0].numpy(), want,
                               atol=np.abs(want).max() / 64)


def test_forgetting_check_catches_a_fault(monkeypatch):
    """Voxels whose rows form a chain of near-duplicates (each within
    cosine 0.98 of the next, 0.93 of the one after): K rounds of label
    propagation merge the chain as JAX does; one round leaves it split,
    which must fail the comparison."""
    cfg = small_test_config()
    K, D = cfg.memory.cache_size, cfg.memory.token_dim
    js = jstore.init_store(cfg.memory)
    V1 = js.feat_count.shape[0]
    rng = np.random.default_rng(2)
    a = rng.normal(size=D)
    b = rng.normal(size=D)
    b -= (a @ b) / (a @ a) * a
    b *= np.linalg.norm(a) / np.linalg.norm(b)
    # rows t = 0, 0.4, 0.6, 0.2 along a + t b: 0-3-1-2 adjacent in turn
    rows = np.stack([a + t * b for t in (0.0, 0.4, 0.6, 0.2)])
    feats = np.zeros((V1, K, D), np.float32)
    feats[:50] = rows.astype(np.float32)
    js = js.replace(feats=jnp.asarray(feats.reshape(V1 * K, D)),
                    feat_norm=jnp.asarray(np.linalg.norm(
                        feats, axis=-1).reshape(V1 * K)),
                    feat_count=jnp.asarray(np.where(np.arange(V1) < 50, K,
                                                    0).astype(np.int32)))
    assert_pairs_clear_threshold(js, 0.95)
    want = jrep.forgetting_pass(js, threshold=0.95)
    assert int(want.feat_count[0]) == 1
    assert_forgotten_equal(trep.forgetting_pass(to_port(js)), want)
    labels = trep._component_labels
    monkeypatch.setattr(trep, "_component_labels",
                        lambda adj, rounds: labels(adj, 1))
    with pytest.raises(AssertionError):
        assert_forgotten_equal(trep.forgetting_pass(to_port(js)), want)


def test_full_f32_matmul_restores_the_flags():
    prec = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("medium")
    try:
        with full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = tf32
