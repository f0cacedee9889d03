"""K2b's tensor-core order on the CPU: ``torch_parity.tensor_core_scan``,
which takes the products and sums of bsc_nav_tpu_torch/csrc/max_cosine.cu
``max_cosine_mma_kernel`` (bf16 and int8 rows), against JAX's jitted
``max_cosine_per_voxel_batch``, and the faults its bound must catch.

The bound is the f32 dot bound of ``test_torch_similarity._dot_bound``
(u = 2^-24): JAX sums D products in f32 within gamma_{D+1}; the tensor
cores add D / 16 exact k16 sums to an f32 accumulator rounded toward zero,
within gamma_{D/16 + 1} at u = 2^-23, which is smaller for every D >= 16,
so the truncation needs no larger bound.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import similarity as jsim
from bsc_nav_tpu_torch.ops import similarity as tsim
from test_torch_similarity import _check, _int8_rows, _store
from torch_parity import tensor_core_scan


def _case(dtype, V1, K, D, Q, seed):
    """(rows as the kernel reads them, the same rows in f32, norms,
    counts, qs, qs rounded to bf16, JAX's [Q, V1] result)."""
    feats, norms, counts, _ = _store(V1, K, D, seed=seed)
    rng = np.random.default_rng(seed + 100)
    qs = rng.normal(size=(Q, D)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    if dtype == "int8":
        rows, norms = _int8_rows(feats, norms)
        rows = torch.from_numpy(rows)
        jrows = jnp.asarray(rows.numpy())
    else:
        rows = torch.from_numpy(feats).to(torch.bfloat16)
        jrows = jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jsim.max_cosine_per_voxel_batch(
        jrows, *map(jnp.asarray, (norms, counts, qs))))
    qr = torch.from_numpy(qs).to(torch.bfloat16).float().numpy()
    return rows, rows.float().numpy(), norms, counts, qs, qr, want


def _check_all(got, want, rows_f, norms, counts, qr):
    assert got.shape == want.shape
    for j in range(want.shape[0]):
        _check(got[j], want[j], rows_f, norms, counts, qr[j])


# ragged V1 (61 voxels: 7 groups of 8 at K 10 and 5 over; 45: 2 groups of
# 16 at K 7 and 13 over); D 64 is one or two k-blocks, D 1024 sixteen or
# thirty-two
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("Q", [1, 3, 16, 17])
@pytest.mark.parametrize("V1,K,D", [(61, 10, 64), (61, 10, 1024),
                                    (45, 7, 64), (45, 7, 1024)])
def test_tensor_core_order_matches_jax(dtype, Q, V1, K, D):
    """Queries rounded to bf16 and codes widened exactly on both sides;
    the tensor cores' k order and truncating sums within the f32 dot bound
    of JAX's batch scan, and of the port's plain version."""
    rows, rows_f, norms, counts, qs, qr, want = _case(dtype, V1, K, D, Q,
                                                      seed=Q + K + D)
    got = tensor_core_scan(rows, norms, counts, qs).numpy()
    _check_all(got, want, rows_f, norms, counts, qr)
    plain = tsim.max_cosine_per_voxel_batch(
        rows, *map(torch.from_numpy, (norms, counts, qs))).numpy()
    _check_all(got, plain, rows_f, norms, counts, qr)


@pytest.mark.parametrize("dtype,fault", [
    ("bfloat16", "drop_step"), ("int8", "drop_step"), ("int8", "unsigned"),
    ("bfloat16", "past_count"), ("int8", "past_count"),
    ("bfloat16", "rows_only"), ("int8", "rows_only")])
def test_bound_catches_a_fault(dtype, fault):
    """A lost k16 step, int8 codes read as unsigned, a row past the count
    taken as live, or the rows' k permuted and not the queries': each
    fails the check -- the bound, or for a row past the count the -inf
    pattern of the empty voxels first."""
    rows, rows_f, norms, counts, qs, qr, want = _case(dtype, 61, 10, 1024, 3,
                                                      seed=7)
    got = tensor_core_scan(rows, norms, counts, qs, fault=fault).numpy()
    with pytest.raises(AssertionError,
                       match="outside the f32 dot bound|not equal"):
        _check_all(got, want, rows_f, norms, counts, qr)


def test_a_row_past_the_count_fails_the_bound_too():
    """On the voxels that are not empty, where the -inf pattern cannot
    tell, a row past the count still moves the max past the bound."""
    V1, K = 61, 10
    rows, rows_f, norms, counts, qs, qr, want = _case("int8", V1, K, 1024,
                                                      3, seed=7)
    full = counts > 0

    def sub(a):
        return a.reshape(V1, K, *a.shape[1:])[full].reshape(-1, *a.shape[1:])

    got = tensor_core_scan(rows, norms, counts, qs, fault="past_count")
    with pytest.raises(AssertionError, match="outside the f32 dot bound"):
        _check_all(got.numpy()[:, full], want[:, full], sub(rows_f),
                   sub(norms), counts[full], qr)
