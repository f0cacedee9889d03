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


def _check(got, want, atol):
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=1e-5)


@pytest.mark.parametrize("D", [32, 128])
def test_plain_matches_pallas_interpret(D):
    # VK % 1024 == 0: the Pallas kernel's own gate; f32 both sides.
    # Valid zero-norm rows divide by 1e-12 -- huge but finite and equal in
    # relative terms, hence rtol 1e-5 beside 1e-5 abs.
    feats, norms, counts, q = _store(256, 4, D)
    want = np.asarray(jsim.max_cosine_per_voxel(
        *map(jnp.asarray, (feats, norms, counts, q)), interpret=True))
    got = tsim.max_cosine_per_voxel(
        *map(torch.from_numpy, (feats, norms, counts, q))).numpy()
    _check(got, want, 1e-5)


def test_plain_matches_jax_reference_ragged():
    feats, norms, counts, q = _store(37, 10, 24, seed=1)
    want = np.asarray(jsim.reference_max_cosine(
        *map(jnp.asarray, (feats, norms, counts, q))))
    got = tsim.reference_max_cosine(
        *map(torch.from_numpy, (feats, norms, counts, q))).numpy()
    _check(got, want, 1e-5)


def test_masked_norms_matches_jax():
    _, norms, counts, _ = _store(19, 5, 8, seed=2)
    want = np.asarray(jsim.masked_norms(jnp.asarray(norms),
                                        jnp.asarray(counts), 5))
    got = tsim.masked_norms(torch.from_numpy(norms),
                            torch.from_numpy(counts), 5).numpy()
    np.testing.assert_array_equal(got, want)


def test_bf16_rows_match_pallas_interpret():
    # bf16 rows widened to f32 and dotted with the f32 query, as the TPU
    # kernel does: equal inputs, f32 sums in another order -> 1e-5
    feats, norms, counts, q = _store(256, 4, 64, seed=3)
    fb = torch.from_numpy(feats).to(torch.bfloat16)
    want = np.asarray(jsim.max_cosine_per_voxel(
        jnp.asarray(fb.float().numpy()).astype(jnp.bfloat16),
        *map(jnp.asarray, (norms, counts, q)), interpret=True))
    got = tsim.max_cosine_per_voxel(
        fb, *map(torch.from_numpy, (norms, counts, q))).numpy()
    _check(got, want, 1e-5)
