"""Port parity: the store scan (kernel K2) and its plain version against
bsc_nav_tpu/ops/similarity.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import similarity as jsim
from bsc_nav_tpu_torch.ops import similarity as tsim


def _store(V1, K, D, seed=0):
    """Random rows with empty voxels (count 0), partly filled voxels and
    valid zero-norm rows."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(V1 * K, D)).astype(np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    counts = rng.integers(0, K + 1, size=V1).astype(np.int32)
    counts[:3] = 0
    zero = rng.choice(V1 * K, size=V1 * K // 16, replace=False)
    norms[zero] = 0.0
    feats[zero[: len(zero) // 2]] = 0.0
    q = rng.normal(size=D).astype(np.float32)
    q /= np.linalg.norm(q)
    return feats, norms, counts, q


def _dot_bound(feats, norms, counts, q):
    """Per voxel, how far two f32 evaluations of its max cosine may lie
    apart: a D-term dot product summed in any order is within
    gamma_D sum_i |r_i||q_i| of the exact value and the quotient adds one
    rounding, so two evaluations of a row's cosine differ by at most
    2 gamma_{D+1} sum_i |r_i||q_i| / max(norm, 1e-12); the voxel's max by
    at most the largest such bound over its live rows.  Valid rows of
    norm 0 (kept on purpose) divide by 1e-12, so their cosines and bounds
    reach ~1e12."""
    V1, D = counts.shape[0], feats.shape[1]
    K = feats.shape[0] // V1
    u = 2.0 ** -24
    gamma = (D + 1) * u / (1 - (D + 1) * u)
    absdot = np.abs(np.asarray(feats, np.float64)) @ np.abs(
        np.asarray(q, np.float64))
    rows = 2 * gamma * absdot / np.maximum(norms.astype(np.float64), 1e-12)
    live = np.arange(K)[None, :] < counts[:, None]
    return np.where(live, rows.reshape(V1, K), 0.0).max(axis=1)


def _check(got, want, feats, norms, counts, q):
    """Equal empty voxels (-inf); elsewhere within the f32 dot bound
    (``_dot_bound``) plus 1e-5 absolute."""
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    err = np.abs(got[live].astype(np.float64) - want[live])
    bound = 1e-5 + _dot_bound(feats, norms, counts, q)[live]
    assert np.all(err <= bound), (
        f"{int((err > bound).sum())} voxels outside the f32 dot bound, "
        f"worst {(err / bound).max():.3g}x")


@pytest.mark.parametrize("D", [32, 128])
def test_plain_matches_pallas_interpret(D):
    # VK % 1024 == 0: the Pallas kernel's own gate; f32 both sides.
    # Valid zero-norm rows divide by 1e-12 -- huge but finite, held to
    # the f32 dot bound scaled the same way.
    feats, norms, counts, q = _store(256, 4, D)
    want = np.asarray(jsim.max_cosine_per_voxel(
        *map(jnp.asarray, (feats, norms, counts, q)), interpret=True))
    got = tsim.max_cosine_per_voxel(
        *map(torch.from_numpy, (feats, norms, counts, q))).numpy()
    _check(got, want, feats, norms, counts, q)


def test_plain_matches_jax_reference_ragged():
    feats, norms, counts, q = _store(37, 10, 24, seed=1)
    want = np.asarray(jsim.reference_max_cosine(
        *map(jnp.asarray, (feats, norms, counts, q))))
    got = tsim.reference_max_cosine(
        *map(torch.from_numpy, (feats, norms, counts, q))).numpy()
    _check(got, want, feats, norms, counts, q)


def test_masked_norms_matches_jax():
    _, norms, counts, _ = _store(19, 5, 8, seed=2)
    want = np.asarray(jsim.masked_norms(jnp.asarray(norms),
                                        jnp.asarray(counts), 5))
    got = tsim.masked_norms(torch.from_numpy(norms),
                            torch.from_numpy(counts), 5).numpy()
    np.testing.assert_array_equal(got, want)


def _bf16_case():
    feats, norms, counts, q = _store(256, 4, 64, seed=3)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    want = np.asarray(jsim.max_cosine_per_voxel(
        jnp.asarray(fb.float().numpy()).astype(jnp.bfloat16),
        *map(jnp.asarray, (norms, counts, q)), interpret=True))
    return fb, norms, counts, q, want


def test_bf16_rows_match_pallas_interpret():
    # bf16 rows widened to f32 and dotted with the f32 query, as the TPU
    # kernel does: equal inputs, f32 sums in another order -> the f32 dot
    # bound on the widened rows
    fb, norms, counts, q, want = _bf16_case()
    got = tsim.max_cosine_per_voxel(
        fb, *map(torch.from_numpy, (norms, counts, q))).numpy()
    _check(got, want, fb.float().numpy(), norms, counts, q)


def _max_row(fb, norms, counts, q, last_only):
    """(voxel, row) of the live row of norm > 0 whose loss moves its
    voxel's max the most: any row, or only each voxel's last live row."""
    V1 = counts.shape[0]
    K = fb.shape[0] // V1
    cos = (fb.float().numpy().astype(np.float64) @ q) / np.maximum(
        norms.astype(np.float64), 1e-12)
    cos = np.where(np.arange(K)[None, :] < counts[:, None],
                   cos.reshape(V1, K), -np.inf)
    best = (-np.inf, None)
    for v in np.flatnonzero((counts >= 2) & (np.abs(cos) < 2).all(1)):
        r = int(counts[v]) - 1 if last_only else int(cos[v].argmax())
        gap = cos[v, r] - np.delete(cos[v], r).max()
        if gap > best[0]:
            best = (gap, (int(v), r))
    return best[1]


@pytest.mark.parametrize("fault", ["dropped_row", "count_off_by_one"])
def test_bf16_bound_catches_a_fault(fault):
    """The bound still fails a scan that loses one live row (its dot never
    taken) or reads a count one short."""
    fb, norms, counts, q, want = _bf16_case()
    bad_fb, bad_counts = fb.clone(), counts.copy()
    v, r = _max_row(fb, norms, counts, q, last_only=fault != "dropped_row")
    if fault == "dropped_row":
        bad_fb[v * (fb.shape[0] // counts.shape[0]) + r] = 0
    else:
        bad_counts[v] -= 1
    got = tsim.max_cosine_per_voxel(
        bad_fb, *map(torch.from_numpy, (norms, bad_counts, q))).numpy()
    with pytest.raises(AssertionError, match="outside the f32 dot bound"):
        _check(got, want, fb.float().numpy(), norms, counts, q)


def _int8_rows(feats, norms):
    """JAX's int8 store rows of ``feats``: per-row absmax codes and the
    int8-row norms (``quantize_feat_rows``)."""
    from bsc_nav_tpu.memory.store import quantize_feat_rows
    qi, qn, _ = quantize_feat_rows(jnp.asarray(feats), jnp.asarray(norms))
    return np.array(qi), np.array(qn)


def test_int8_rows_match_jax_reference():
    """int8 rows (widened exactly) dotted with the query rounded to bf16,
    as JAX's int8 einsum takes them: the f32 dot bound on the codes and
    the rounded query."""
    feats, norms, counts, q = _store(53, 10, 64, seed=4)
    qi, qn = _int8_rows(feats, norms)
    want = np.asarray(jsim.reference_max_cosine(
        *map(jnp.asarray, (qi, qn, counts, q))))
    got = tsim.max_cosine_per_voxel(
        *map(torch.from_numpy, (qi, qn, counts, q))).numpy()
    qb = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    _check(got, want, qi.astype(np.float32), qn, counts, qb)
    # the query is rounded: an f32 query misses the bound somewhere
    f32q = tsim._per_voxel_max(torch.from_numpy(qi).float()
                               @ torch.from_numpy(q), torch.from_numpy(qn),
                               torch.from_numpy(counts)).numpy()
    with pytest.raises(AssertionError, match="outside the f32 dot bound"):
        _check(f32q, want, qi.astype(np.float32), qn, counts, qb)


def _batch_case(dtype, Q, seed):
    """(port rows, numpy rows as the kernel reads them, norms, counts, qs,
    qs rounded as JAX's batch rounds them, JAX's [Q, V1] result)."""
    feats, norms, counts, _ = _store(61, 10, 96, seed=seed)
    rng = np.random.default_rng(seed + 100)
    qs = rng.normal(size=(Q, 96)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    if dtype == "int8":
        qi, norms = _int8_rows(feats, norms)
        rows, jrows = torch.from_numpy(qi), jnp.asarray(qi)
    elif dtype == "bfloat16":
        rows = torch.from_numpy(feats).to(torch.bfloat16)
        jrows = jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16)
    else:
        rows, jrows = torch.from_numpy(feats), jnp.asarray(feats)
    want = np.asarray(jsim.max_cosine_per_voxel_batch(
        jrows, *map(jnp.asarray, (norms, counts, qs))))
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    qr = torch.from_numpy(qs).to(qdt).float().numpy()
    return rows, rows.float().numpy(), norms, counts, qs, qr, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("Q", [1, 3, 17])
def test_batch_scan_matches_jax(dtype, Q):
    """The Q-query scan's plain version (the GEMM composition) against JAX
    ``max_cosine_per_voxel_batch``: queries rounded to the store dtype
    (bf16 for int8 rows) on both sides, each query's row of the result
    within the f32 dot bound on the rounded query."""
    rows, rows_f, norms, counts, qs, qr, want = _batch_case(dtype, Q, Q)
    got = tsim.max_cosine_per_voxel_batch(
        rows, *map(torch.from_numpy, (norms, counts, qs))).numpy()
    assert got.shape == want.shape == (Q, counts.shape[0])
    for j in range(Q):
        _check(got[j], want[j], rows_f, norms, counts, qr[j])


def test_batch_rounds_its_queries_where_the_single_scan_does_not():
    """On bf16 rows the single-query scan keeps an f32 query (the TPU
    kernel's, ``test_bf16_rows_match_pallas_interpret``), the Q-query scan
    rounds it to bf16 (the JAX batch einsum's): each holds its own JAX
    counterpart, and the two differ past the bound."""
    rows, rows_f, norms, counts, qs, qr, want = _batch_case("bfloat16", 1, 5)
    batch = tsim.max_cosine_per_voxel_batch(
        rows, *map(torch.from_numpy, (norms, counts, qs))).numpy()
    _check(batch[0], want[0], rows_f, norms, counts, qr[0])
    single = tsim.max_cosine_per_voxel(
        rows, *map(torch.from_numpy, (norms, counts, qs[0]))).numpy()
    with pytest.raises(AssertionError, match="outside the f32 dot bound"):
        _check(single, want[0], rows_f, norms, counts, qr[0])
