"""The port's CUDA kernels (K1 short_attention_qkv, K2 max_cosine_per_voxel,
K3 short_attention, K4 joint_qkv_attention, K5 mid_attention, K6
flash_attention, K7 layer_norm, K8 conv3x3_s1) against their plain PyTorch
versions.

This file imports no JAX, so the card tests also run where JAX is not
installed.  On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX.)  Without a card the
``cuda`` tests skip; the CPU tests here check the dispatch rule: a CPU
tensor takes the plain version and launches nothing.
"""

import ctypes
import pathlib

import numpy as np
import pytest
import torch

from bsc_nav_tpu_torch.config import small_test_config
from bsc_nav_tpu_torch.memory import pipeline as tpipe
from bsc_nav_tpu_torch.memory import store as tstore
from bsc_nav_tpu_torch.memory.store import init_store
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.ops import _build
from bsc_nav_tpu_torch.ops import conv2d as tconv
from bsc_nav_tpu_torch.ops import flash_attention as tfa
from bsc_nav_tpu_torch.ops import layernorm as tln
from bsc_nav_tpu_torch.ops import similarity as tsim
from bsc_nav_tpu_torch.profiling import device_kernels


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build and run only "
                    "on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, S, heads, hd, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(size=(B, S, 3 * heads * hd)).astype(np.float32))


def _store(V1, K, D, seed=0):
    """Random rows; empty, partly filled and full voxels; zero rows with
    norm 0, as ingest stores a zero token (masked_norms divides them by
    1e-12, and 0 / 1e-12 is exact on both sides)."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(V1 * K, D)).astype(np.float32)
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    counts = rng.integers(0, K + 1, size=V1).astype(np.int32)
    counts[:3] = 0
    zero = rng.choice(V1 * K, size=max(1, V1 * K // 16), replace=False)
    feats[zero] = 0.0
    norms[zero] = 0.0
    q = rng.normal(size=D).astype(np.float32)
    q /= np.linalg.norm(q)
    return [torch.from_numpy(a) for a in (feats, norms, counts, q)]


def _bhsd(B, H, S, hd, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(B, H, S, hd)).astype(np.float32))


def _joint(B, Sx, Sc, heads, seed):
    """Two streams' fused qkv (head_dim 64) and four distinct gammas."""
    rng = np.random.default_rng(seed)
    D = heads * 64
    x, c = (torch.from_numpy(rng.normal(size=(B, S, 3 * D)).astype(
        np.float32)) for S in (Sx, Sc))
    g = [torch.from_numpy(rng.uniform(0.2, 2.0, size=64).astype(np.float32))
         for _ in range(4)]
    return x, c, g


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each element of x (8 significant
    bits)."""
    mag = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# the launchers' counts of each counted kernel (csrc/mma_bf16.cuh
# TileKind): the tensor-core tiles, then K2b's tensor-core kernel (bf16
# and int8 rows) and its CUDA-core kernel (f32 rows)
TILE_NAMES = ("attention_wgmma_kernel", "attention_tf32_kernel",
              "conv3x3_s1_mma_kernel", "conv3x3_s1_tf32_kernel",
              "attention_tma_kernel", "max_cosine_mma_kernel",
              "max_cosine_batch_kernel")


def _tile_launches(fn) -> dict:
    """fn() runs once; how many launches of each of TILE_NAMES it made, by
    the launchers' own counts (``bsc_tile_launches``)."""
    lib = _build.kernels()
    arr = (ctypes.c_longlong * len(TILE_NAMES)).in_dll(lib,
                                                      "bsc_tile_launches")
    before = tuple(arr)
    fn()
    torch.cuda.synchronize()
    return {n: a - b for n, a, b in zip(TILE_NAMES, tuple(arr), before)}


def _check_sims(got, want, atol):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    qkv = _qkv(1, 9, 2, 16)
    n1 = tfa.short_attention_qkv.launches
    torch.testing.assert_close(tfa.short_attention_qkv(qkv, 2),
                               tfa.short_attention_qkv_reference(qkv, 2))
    store = _store(5, 3, 8)
    n2 = tsim.max_cosine_per_voxel.launches
    n2b = tsim.max_cosine_per_voxel_batch.launches
    torch.testing.assert_close(tsim.max_cosine_per_voxel(*store),
                               tsim.reference_max_cosine(*store))
    qs = torch.stack([store[3]] * 17)
    torch.testing.assert_close(
        tsim.max_cosine_per_voxel_batch(*store[:3], qs),
        tsim.reference_max_cosine_batch(*store[:3], qs))
    q, k, v = _qkv(2, 9, 2, 16).reshape(2, 9, 3, 2, 16).unbind(2)
    n3 = tfa.short_attention.launches
    torch.testing.assert_close(tfa.short_attention(q, k, v, causal=True),
                               tfa.short_attention_reference(q, k, v, True))
    x, c, g = _joint(1, 9, 4, 2, seed=1)
    n4 = tfa.joint_qkv_attention.launches
    torch.testing.assert_close(tfa.joint_qkv_attention(x, c, 2, *g),
                               tfa.joint_qkv_attention_reference(x, c, 2, *g))
    n4n = tfa.joint_qk_norm.launches
    torch.testing.assert_close(tfa.joint_qk_norm(x, c, 2, *g),
                               tfa.joint_qk_norm_reference(x, c, 2, *g))
    q, k = _bhsd(1, 2, 5, 16, 8), _bhsd(1, 2, 700, 16, 9)
    n5, n6 = tfa.mid_attention.launches, tfa.flash_attention.launches
    torch.testing.assert_close(tfa.mid_attention(q, k, k),
                               tfa.mid_attention_reference(q, k, k))
    torch.testing.assert_close(tfa.flash_attention(k, k, k, causal=True),
                               tfa.flash_attention_reference(k, k, k, True))
    x = _bhsd(2, 3, 4, 40, 10)
    n7 = tln.layer_norm.launches
    torch.testing.assert_close(
        tln.layer_norm(x, x[0, 0, 0], x[0, 0, 1]),
        tln.layer_norm_reference(x, x[0, 0, 0], x[0, 0, 1]))
    w = _bhsd(1, 9, 40, 6, 11)[0]
    n8 = tconv.conv3x3_s1.launches
    torch.testing.assert_close(tconv.conv3x3_s1(x, w, w[0, 0]),
                               tconv.conv3x3_s1_reference(x, w, w[0, 0]))
    assert tfa.short_attention_qkv.launches == n1
    assert tsim.max_cosine_per_voxel.launches == n2
    assert tsim.max_cosine_per_voxel_batch.launches == n2b
    assert tfa.short_attention.launches == n3
    assert tfa.joint_qkv_attention.launches == n4
    assert tfa.joint_qk_norm.launches == n4n
    assert tfa.mid_attention.launches == n5
    assert tfa.flash_attention.launches == n6
    assert tln.layer_norm.launches == n7
    assert tconv.conv3x3_s1.launches == n8


def test_kernel_sources_are_the_build_inputs():
    names = {p.name for p in _build.sources()}
    assert names == {"short_attention_qkv.cu", "max_cosine.cu",
                     "short_attention.cu", "joint_qkv_attention.cu",
                     "mid_attention.cu", "flash_attention.cu",
                     "layer_norm.cu", "conv3x3_s1.cu"}
    for p in _build.sources():
        head = pathlib.Path(p).read_text()[:3000]
        assert "Replaces: bsc_nav_tpu/ops/" in head and "Bound on" in head


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,heads,hd", [(2, 261, 16, 64), (3, 37, 2, 16),
                                          (1, 130, 3, 128), (2, 65, 5, 48)])
def test_k1_matches_plain(cuda, B, S, heads, hd, dtype):
    """f32 (the TF32 tile, three TF32 products per f32 product): sums in
    another order, 2e-5 abs.  bf16 (the wgmma tile) rounds P to bf16:
    ``short_attention_qkv_bf16_tolerance``."""
    qkv = _qkv(B, S, heads, hd, seed=3).to(cuda, dtype)
    before = tfa.short_attention_qkv.launches
    got = tfa.short_attention_qkv(qkv, heads)
    assert tfa.short_attention_qkv.launches == before + 1
    want = tfa.short_attention_qkv_reference(qkv, heads)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, heads * hd)
    diff = (got.float() - want.float()).abs()
    tol = (2e-5 if dtype == torch.float32 else
           tfa.short_attention_qkv_bf16_tolerance(qkv, heads, want))
    assert bool((diff <= tol).all()), diff.max().item()


# K1's edges on the bf16 tile: ViT-L's S 261 (a 5-row last q tile) and
# the text length 77 at hd 64 (swizzled), odd B and head counts, every
# other head_dim K1 takes (core matrices), S 1 and 640
K1_EDGES = [(8, 261, 16, 64), (3, 77, 16, 64), (1, 77, 3, 64),
            (2, 1, 2, 64), (1, 640, 2, 64), (3, 261, 5, 16),
            (1, 77, 2, 32), (2, 129, 3, 48), (1, 261, 2, 80),
            (1, 65, 3, 96), (2, 200, 1, 112), (1, 257, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,heads,hd", K1_EDGES)
def test_k1_bf16_tensor_core_tile_edges(cuda, B, S, heads, hd):
    """K1 in bf16, q, k and v read in place from the fused rows, at the
    tile's edges, within ``short_attention_qkv_bf16_tolerance``."""
    qkv = _qkv(B, S, heads, hd, seed=24).to(cuda, torch.bfloat16)
    before = tfa.short_attention_qkv.launches
    got = tfa.short_attention_qkv(qkv, heads)
    assert tfa.short_attention_qkv.launches == before + 1
    want = tfa.short_attention_qkv_reference(qkv, heads)
    tol = tfa.short_attention_qkv_bf16_tolerance(qkv, heads, want)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, heads * hd)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,heads,hd", K1_EDGES)
def test_k1_f32_tf32_tile_edges(cuda, B, S, heads, hd):
    """K1 in f32 on the TF32 tile (three TF32 products per f32 product),
    q, k and v read in place from the fused rows, at the tile's edges,
    within the f32 bound of 2e-5 abs."""
    qkv = _qkv(B, S, heads, hd, seed=25).to(cuda)
    before = tfa.short_attention_qkv.launches
    got = tfa.short_attention_qkv(qkv, heads)
    assert tfa.short_attention_qkv.launches == before + 1
    want = tfa.short_attention_qkv_reference(qkv, heads)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, S, heads * hd)
    diff = (got - want).abs()
    assert bool((diff <= 2e-5).all()), diff.max().item()


@pytest.mark.cuda
def test_k1_k4_take_the_tile_in_bf16_only(cuda):
    """By dtype alone: bf16 launches the wgmma tile for K1 (FusedQKV
    policy) and K3 (Contiguous), and K4's qk-norm pre-pass then the TMA
    tile; f32 launches the TF32 tile for K1 (FusedQKV) and K3
    (Contiguous), and K4's pre-pass then the TF32 tile (FusedQKV); one
    kernel each, two for K4."""
    qkv = _qkv(2, 77, 2, 64, seed=5).to(cuda)
    x, c, g = _joint(1, 100, 77, 2, seed=5)
    x, c = x.to(cuda), c.to(cuda)
    g = [t.to(cuda) for t in g]
    q, k, v = (_bhsd(2, 3, 77, 80, s).to(cuda) for s in (5, 6, 7))
    for dtype, tile in ((torch.float32, False), (torch.bfloat16, True)):
        k1 = device_kernels(
            lambda: tfa.short_attention_qkv(qkv.to(dtype), 2))
        k1 = [n for n in k1 if "short_attention_qkv" in n]
        k4 = device_kernels(
            lambda: tfa.joint_qkv_attention(x.to(dtype), c.to(dtype), 2, *g))
        k4 = [n for n in k4 if "joint_qkv" in n]
        k3 = device_kernels(lambda: tfa.short_attention(
            q.to(dtype), k.to(dtype), v.to(dtype), causal=True))
        k3 = [n for n in k3 if "short_attention" in n]
        assert len(k1) == 1 and len(k4) == 2 and len(k3) == 1, (k1, k4, k3)
        assert "joint_qkv_norm_kernel" in k4[0], k4
        if tile:
            assert "attention_wgmma_kernel" in k1[0] and "FusedQKV" in k1[0]
            assert "attention_tma_kernel" in k4[1], k4
            assert "attention_wgmma_kernel" in k3[0] and "Contiguous" in k3[0]
        else:
            for name, policy in ((k1[0], "FusedQKV"), (k3[0], "Contiguous"),
                                 (k4[1], "FusedQKV")):
                assert "attention_tf32_kernel" in name, name
                assert policy in name and "float" in name, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, "attention_tma_kernel"),
    (torch.float32, "attention_tf32_kernel")])
@pytest.mark.parametrize("B,Sx,Sc,heads", [(2, 100, 77, 2), (1, 200, 0, 3),
                                           (1, 4096, 0, 2)],
                         ids=["Sx-not-a-multiple-of-128", "Sc-0", "S4096"])
def test_k4_takes_the_tma_tile_in_bf16_and_the_tf32_tile_in_f32(
        cuda, B, Sx, Sc, heads, dtype, tile):
    """By the launchers' counts: each K4 call launches one attention tile,
    the TMA tile in bf16 and the TF32 tile in f32, and no other."""
    x, c, g = _joint(B, Sx, Sc, heads, seed=7)
    x, c = x.to(cuda, dtype), c.to(cuda, dtype)
    g = [t.to(cuda) for t in g]
    if Sc == 0:
        c = x[:, :0]
    before = tfa.joint_qkv_attention.launches
    took = _tile_launches(lambda: tfa.joint_qkv_attention(x, c, heads, *g))
    assert tfa.joint_qkv_attention.launches == before + 1
    assert took == {n: int(n == tile) for n in TILE_NAMES}, took


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sx,Sc,heads", [(6, 1024, 589, 24),
                                           (2, 100, 77, 2), (3, 130, 0, 5),
                                           (2, 1, 1, 1)])
def test_k4_qk_norm_prepass_matches_plain(cuda, B, Sx, Sc, heads, dtype):
    """K4's pre-pass alone (``joint_qk_norm``) against its plain version:
    v copied exactly; q-hat and k-hat (rsqrtf, sums of squares in another
    order) within 2^-17 of the plain f32 value, so in bf16 equal but where
    that value rounds the other way, and there within one bf16 ulp."""
    x, c, g = _joint(B, Sx, Sc, heads, seed=9)
    x, c = x.to(cuda, dtype), c.to(cuda, dtype)
    g = [t.to(cuda) for t in g]
    if Sc == 0:
        c = x[:, :0]
    before = tfa.joint_qk_norm.launches
    got = tfa.joint_qk_norm(x, c, heads, *g)
    assert tfa.joint_qk_norm.launches == before + 1
    want = tfa.joint_qk_norm_reference(x, c, heads, *g)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, Sx + Sc, 3 * heads * 64)
    D = heads * 64
    assert torch.equal(got[..., 2 * D:], want[..., 2 * D:])
    a, w = got[..., :2 * D].float(), want[..., :2 * D].float()
    tol = (2.0 ** -17 * w.abs() if dtype == torch.float32
           else torch.where(a == w, torch.zeros_like(w), bf16_ulp(w)))
    assert bool(((a - w).abs() <= tol).all()), (a - w).abs().max().item()


@pytest.mark.cuda
def test_k5_k6_take_the_tf32_tile_in_f32(cuda):
    """By dtype alone: f32 K5 and K6 launch the TF32 tile (Contiguous
    policy), bf16 at head_dim 64 the TMA tile; one kernel each, causal or
    not."""
    q, k, v = (_bhsd(1, 2, 700, 64, s).to(cuda) for s in (18, 19, 20))
    for dtype, tile in ((torch.float32, "attention_tf32_kernel"),
                        (torch.bfloat16, "attention_tma_kernel")):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        for name, fn in (
                ("mid_attention", lambda: tfa.mid_attention(qd, kd, vd)),
                ("flash_attention",
                 lambda: tfa.flash_attention(qd, kd, vd, False)),
                ("flash_attention",
                 lambda: tfa.flash_attention(qd, kd, vd, True))):
            names = device_kernels(fn)
            got = [n for n in names if name in n]
            assert len(got) == 1, (got, [n[:100] for n in names[:5]])
            assert tile in got[0], got[0]
            if dtype == torch.float32:
                assert "Contiguous" in got[0], got[0]


@pytest.mark.cuda
def test_k5_k6_bf16_take_the_tma_tile_at_head_dim_64_only(cuda):
    """In bf16, K5 and K6 at head_dim 64 launch attention_tma_kernel; at
    16, 32, 80 and 128 they stay on attention_wgmma_kernel (Contiguous
    policy); one kernel each."""
    for hd in (64, 16, 32, 80, 128):
        q, k, v = (_bhsd(1, 2, 700, hd, s).to(cuda, torch.bfloat16)
                   for s in (21, 22, 23))
        tile = "attention_tma_kernel" if hd == 64 else "attention_wgmma_kernel"
        for name, fn in (
                ("mid_attention", lambda: tfa.mid_attention(q, k, v)),
                ("flash_attention",
                 lambda: tfa.flash_attention(q, k, v, True))):
            names = device_kernels(fn)
            got = [n for n in names if name in n]
            assert len(got) == 1, (hd, got, [n[:100] for n in names[:5]])
            assert tile in got[0], (hd, got[0])
            if hd != 64:
                assert "Contiguous" in got[0], got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V1,K,D", [(1001, 10, 1024), (37, 4, 32),
                                    (8, 3, 8)])
def test_k2_matches_plain(cuda, V1, K, D, dtype):
    """The same bf16 or f32 rows widened to f32 on both sides; f32 dots
    summed in another order: 2e-5 abs."""
    f, n, c, q = (t.to(cuda) for t in _store(V1, K, D, seed=4))
    f = f.to(dtype)
    before = tsim.max_cosine_per_voxel.launches
    got = tsim.max_cosine_per_voxel(f, n, c, q)
    assert tsim.max_cosine_per_voxel.launches == before + 1
    want = tsim.reference_max_cosine(f, n, c, q)
    torch.cuda.synchronize()
    _check_sims(got, want, 2e-5)


def _int8_store(V1, K, D, seed):
    """``_store``'s rows as an int8 store: per-row absmax codes and the
    int8 rows' norms (``quantize_feat_rows``)."""
    f, n, c, q = _store(V1, K, D, seed=seed)
    qi, qn, _ = tstore.quantize_feat_rows(f, n)
    return qi, qn, c, q


def _scan_store(dtype, V1, K, D, seed, dev):
    if dtype == torch.int8:
        store = _int8_store(V1, K, D, seed)
    else:
        store = _store(V1, K, D, seed=seed)
        store[0] = store[0].to(dtype)
    return [t.to(dev) for t in store]


@pytest.mark.cuda
@pytest.mark.parametrize("V1,K,D", [(1001, 10, 1024), (37, 4, 32),
                                    (8, 3, 16)])
def test_k2_int8_matches_plain(cuda, V1, K, D):
    """int8 codes widened exactly, the query rounded to bf16 on both
    sides, every product exact in f32; the dots summed in another order:
    2e-5 abs.  The card takes the Q-query kernel at Q = 1: one launch of
    it, none of K2's single-query kernel."""
    f, n, c, q = _scan_store(torch.int8, V1, K, D, 6, cuda)
    before = (tsim.max_cosine_per_voxel.launches,
              tsim.max_cosine_per_voxel_batch.launches)
    got = tsim.max_cosine_per_voxel(f, n, c, q)
    assert (tsim.max_cosine_per_voxel.launches,
            tsim.max_cosine_per_voxel_batch.launches) == (before[0],
                                                           before[1] + 1)
    want = tsim.reference_max_cosine(f, n, c, q)
    torch.cuda.synchronize()
    _check_sims(got, want, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("Q", [1, 3, 16, 17])
@pytest.mark.parametrize("V1,K,D", [(1001, 10, 1024), (37, 4, 32)])
def test_k2_batch_matches_plain(cuda, V1, K, D, Q, dtype):
    """The Q-query scan against its plain version, the GEMM composition,
    on the same rows and the same queries rounded to the store dtype:
    f32 dots summed in another order, 2e-5 abs; one launch per 16
    queries."""
    f, n, c, _ = _scan_store(dtype, V1, K, D, Q, cuda)
    rng = np.random.default_rng(Q)
    qs = rng.normal(size=(Q, D)).astype(np.float32)
    qs = torch.from_numpy(qs / np.linalg.norm(qs, axis=1,
                                              keepdims=True)).to(cuda)
    before = tsim.max_cosine_per_voxel_batch.launches
    got = tsim.max_cosine_per_voxel_batch(f, n, c, qs)
    assert tsim.max_cosine_per_voxel_batch.launches == before + -(-Q // 16)
    want = tsim.reference_max_cosine_batch(f, n, c, qs)
    torch.cuda.synchronize()
    assert got.shape == (Q, V1)
    _check_sims(got, want, 2e-5)


def _unit_queries(Q, D, seed, dev):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(Q, D)).astype(np.float32)
    return torch.from_numpy(qs / np.linalg.norm(qs, axis=1,
                                                keepdims=True)).to(dev)


def _scan_launches(f, n, c, qs):
    """K2b on the card: its result and the launches of each of its two
    kernels, by the launchers' own counts."""
    out = []
    took = _tile_launches(
        lambda: out.append(tsim.max_cosine_per_voxel_batch(f, n, c, qs)))
    return out[0], (took["max_cosine_mma_kernel"],
                    took["max_cosine_batch_kernel"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Q", [1, 3, 8, 9, 16, 17])
@pytest.mark.parametrize("V1,K,D", [(203, 10, 1024), (77, 7, 64),
                                    (45, 16, 3584), (1001, 10, 64)])
def test_k2b_tensor_core_edges(cuda, V1, K, D, Q, dtype):
    """bf16 and int8 rows on the tensor-core kernel, every launch: Q
    across the n8 tiles (8 / 9) and the launches (16 / 17), V1 not a
    multiple of the voxel group (8 voxels at K 10, 16 at K 7, 1 at K 16),
    D from one k-block to 112; against the plain version on the same rows
    and the same queries rounded to bf16, f32 sums in another order:
    2e-5 abs."""
    f, n, c, _ = _scan_store(dtype, V1, K, D, Q + K, cuda)
    qs = _unit_queries(Q, D, Q, cuda)
    got, took = _scan_launches(f, n, c, qs)
    assert took == (-(-Q // 16), 0)
    want = tsim.reference_max_cosine_batch(f, n, c, qs)
    assert got.shape == (Q, V1)
    _check_sims(got, want, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_k2b_empty_store_and_one_live_row(cuda, dtype):
    """A store with no live row is -inf everywhere, having launched the
    tensor-core kernel; with one live row, only its voxel is finite."""
    f, n, c, _ = _scan_store(dtype, 203, 10, 1024, 5, cuda)
    qs = _unit_queries(9, 1024, 5, cuda)
    empty = torch.zeros_like(c)
    got, took = _scan_launches(f, n, empty, qs)
    assert took == (1, 0)
    assert bool(torch.isneginf(got).all())
    one = empty.clone()
    one[77] = 1
    got, _ = _scan_launches(f, n, one, qs)
    want = tsim.reference_max_cosine_batch(f, n, one, qs)
    assert int(torch.isfinite(got).sum()) == 9
    _check_sims(got, want, 2e-5)


@pytest.mark.cuda
def test_k2b_takes_the_tensor_cores_on_bf16_and_int8_rows_only(cuda):
    """By the launchers' counts: bf16 and int8 rows launch
    max_cosine_mma_kernel, f32 rows max_cosine_batch_kernel, one launch
    per 16 queries either way."""
    qs = _unit_queries(17, 64, 0, cuda)
    for dtype, want in ((torch.float32, (0, 2)), (torch.bfloat16, (2, 0)),
                        (torch.int8, (2, 0))):
        f, n, c, _ = _scan_store(dtype, 37, 10, 64, 1, cuda)
        assert _scan_launches(f, n, c, qs)[1] == want, dtype


@pytest.mark.cuda
def test_k2_batch_refuses_what_it_does_not_take(cuda):
    f, n, c, q = _scan_store(torch.float32, 8, 2, 32, 0, cuda)
    qs = torch.stack([q, q])
    with pytest.raises(ValueError, match="aligned"):
        tsim.max_cosine_per_voxel_batch(
            torch.zeros(1 + f.numel(), device=cuda)[1:].view(f.shape),
            n, c, qs)
    with pytest.raises(ValueError, match="aligned"):
        tsim.max_cosine_per_voxel_batch(
            torch.zeros(1 + f.numel(), dtype=torch.int8,
                        device=cuda)[1:].view(f.shape), n, c, qs)
    with pytest.raises(ValueError, match="D = 8"):
        tsim.max_cosine_per_voxel_batch(
            torch.zeros(16, 8, dtype=torch.int8, device=cuda), n, c,
            qs[:, :8].contiguous())
    with pytest.raises(ValueError, match="Q >= 1"):
        tsim.max_cosine_per_voxel_batch(f, n, c, qs[:0])
    with pytest.raises(ValueError, match="contiguous"):
        tsim.max_cosine_per_voxel_batch(f, n, c, torch.zeros(
            32, 2, device=cuda).T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", [
    (3, 16, 257, 257, 80, False),       # MetaCLIP ViT-H vision tower
    (4, 16, 77, 77, 64, True),          # CLIP text towers
    (2, 3, 50, 203, 80, False),         # ragged, Sq != Sk
    (1, 2, 130, 130, 128, True), (2, 5, 9, 9, 16, False)])
def test_k3_matches_plain(cuda, B, H, Sq, Sk, hd, causal, dtype):
    """f32 (the TF32 tile, three TF32 products per f32 product): sums in
    another order, 2e-5 abs.  bf16 rounds P to bf16 on the tensor cores:
    ``flash_attention_bf16_tolerance``."""
    q = _bhsd(B, H, Sq, hd, 5).to(cuda, dtype)
    k, v = (_bhsd(B, H, Sk, hd, s).to(cuda, dtype) for s in (6, 7))
    before = tfa.short_attention.launches
    got = tfa.short_attention(q, k, v, causal=causal)
    assert tfa.short_attention.launches == before + 1
    want = tfa.short_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, Sq, hd)
    diff = (got.float() - want.float()).abs()
    tol = (2e-5 if dtype == torch.float32 else
           tfa.flash_attention_bf16_tolerance(q, k, v, want, causal))
    assert bool((diff <= tol).all()), diff.max().item()


# K3's edges on the bf16 tile: Sq 1; a second q tile with one or one and a
# half warpgroups live (Sq 65, 129); causal S 77 and 130 at hd 64 and 128;
# K3's longest key range, 640
K3_EDGES = [(2, 3, 1, 1, 64, False), (1, 2, 1, 257, 80, False),
            (2, 2, 65, 65, 80, False), (2, 2, 129, 129, 64, False),
            (1, 3, 65, 200, 48, False), (2, 4, 77, 77, 64, True),
            (2, 4, 77, 77, 128, True), (1, 2, 130, 130, 64, True),
            (1, 2, 130, 130, 128, True), (1, 3, 100, 640, 64, False),
            (1, 2, 640, 640, 80, False), (2, 1, 640, 640, 16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", K3_EDGES)
def test_k3_bf16_tensor_core_tile_edges(cuda, B, H, Sq, Sk, hd, causal):
    """K3 in bf16 through its wrapper at the tile's edges, within
    ``flash_attention_bf16_tolerance``."""
    q = _bhsd(B, H, Sq, hd, 21).to(cuda, torch.bfloat16)
    k, v = (_bhsd(B, H, Sk, hd, s).to(cuda, torch.bfloat16) for s in (22, 23))
    before = tfa.short_attention.launches
    got = tfa.short_attention(q, k, v, causal)
    assert tfa.short_attention.launches == before + 1
    want = tfa.short_attention_reference(q, k, v, causal)
    tol = tfa.flash_attention_bf16_tolerance(q, k, v, want, causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, Sq, hd)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", K3_EDGES)
def test_k3_f32_tf32_tile_edges(cuda, B, H, Sq, Sk, hd, causal):
    """K3 in f32 on the TF32 tile through its wrapper at the tile's edges
    (every head_dim's ring depth: 3 stages at hd <= 64, 2 at 80, 1 at
    128), within the f32 bound of 2e-5 abs."""
    q = _bhsd(B, H, Sq, hd, 26).to(cuda)
    k, v = (_bhsd(B, H, Sk, hd, s).to(cuda) for s in (27, 28))
    before = tfa.short_attention.launches
    got = tfa.short_attention(q, k, v, causal)
    assert tfa.short_attention.launches == before + 1
    want = tfa.short_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, H, Sq, hd)
    diff = (got - want).abs()
    assert bool((diff <= 2e-5).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sx,Sc,heads", [
    (6, 1024, 589, 24),                 # SD3.5 joint, CLIP + T5-512 context
    (6, 1024, 154, 24),                 # joint without T5
    (6, 1024, 0, 24),                   # MMDiT-X self-attention
    (2, 37, 5, 2), (1, 3, 70, 3), (2, 65, 0, 1)])
def test_k4_matches_plain(cuda, B, Sx, Sc, heads, dtype):
    """f32 (the pre-pass, then the three-pass TF32 tile): the same f32
    qk-norm and softmax, sums in another order (and rsqrtf against
    torch.rsqrt): 2e-5 abs on outputs below ~3.  bf16 (the pre-pass, then
    the TMA tile) rounds q-hat, k-hat and P to bf16:
    ``joint_qkv_attention_bf16_tolerance`` against the plain version of
    that order, ``joint_qkv_attention_bf16_reference``."""
    x, c, g = _joint(B, Sx, Sc, heads, seed=Sx + Sc)
    x, c = x.to(cuda, dtype), c.to(cuda, dtype)
    g = [t.to(cuda) for t in g]
    before = tfa.joint_qkv_attention.launches
    got = tfa.joint_qkv_attention(x, c, heads, *g)
    assert tfa.joint_qkv_attention.launches == before + 1
    if dtype == torch.float32:
        want = tfa.joint_qkv_attention_reference(x, c, heads, *g)
        tol = 2e-5
    else:
        want = tfa.joint_qkv_attention_bf16_reference(x, c, heads, *g)
        tol = tfa.joint_qkv_attention_bf16_tolerance(x, c, heads, *g, want)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, Sx + Sc, heads * 64)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), diff.max().item()


# K4's edges on its tiles: the joint sequence at 512^2 (its q tile of
# rows 1024-1151 straddles the streams), Sx < 128 (the first q tile does),
# Sc 0 (the self-attention: ctx never read), S 1, a lone ctx row, odd B
# and head counts, and B*heads past a grid dimension's 65535
K4_EDGES = [(2, 1024, 589, 24), (2, 100, 77, 2), (3, 1024, 0, 3),
            (1, 1, 0, 2), (2, 127, 1, 1), (1, 0, 65, 2), (3, 130, 61, 5),
            (70000, 8, 0, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sx,Sc,heads", K4_EDGES)
def test_k4_bf16_tensor_core_tile_edges(cuda, B, Sx, Sc, heads):
    """K4 in bf16 through its wrapper at the tile's edges, within
    ``joint_qkv_attention_bf16_tolerance`` of
    ``joint_qkv_attention_bf16_reference``; with Sc 0 the ctx stream is
    an empty view that must never be read."""
    x, c, g = _joint(B, Sx, Sc, heads, seed=40 + Sx + Sc)
    x, c = x.to(cuda, torch.bfloat16), c.to(cuda, torch.bfloat16)
    g = [t.to(cuda) for t in g]
    if Sc == 0:
        c = x[:, :0]
    before = tfa.joint_qkv_attention.launches
    got = tfa.joint_qkv_attention(x, c, heads, *g)
    assert tfa.joint_qkv_attention.launches == before + 1
    want = tfa.joint_qkv_attention_bf16_reference(x, c, heads, *g)
    tol = tfa.joint_qkv_attention_bf16_tolerance(x, c, heads, *g, want)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, Sx + Sc,
                                                         heads * 64)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sx,Sc,heads", K4_EDGES)
def test_k4_f32_tf32_tile_edges(cuda, B, Sx, Sc, heads):
    """K4 in f32 through its wrapper at the same edges, within 2e-5 abs of
    ``joint_qkv_attention_reference``; any B*heads (the CUDA-core kernel
    this replaced took at most 65535)."""
    x, c, g = _joint(B, Sx, Sc, heads, seed=40 + Sx + Sc)
    x, c = x.to(cuda), c.to(cuda)
    g = [t.to(cuda) for t in g]
    if Sc == 0:
        c = x[:, :0]
    before = tfa.joint_qkv_attention.launches
    got = tfa.joint_qkv_attention(x, c, heads, *g)
    assert tfa.joint_qkv_attention.launches == before + 1
    want = tfa.joint_qkv_attention_reference(x, c, heads, *g)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, Sx + Sc,
                                                        heads * 64)
    diff = (got - want).abs()
    assert bool((diff <= 2e-5).all()), diff.max().item()


@pytest.mark.cuda
def test_k4_bf16_self_attention_at_1024px(cuda):
    """The dual self-attention of the 1024^2 text query (S 4096, 24 heads)
    at B 2, held to its plain version one batch row at a time (the plain
    logits of the whole call would be 3.2 GB per tensor)."""
    x, _, g = _joint(2, 4096, 0, 24, seed=41)
    x = x.to(cuda, torch.bfloat16)
    g = [t.to(cuda) for t in g]
    before = tfa.joint_qkv_attention.launches
    got = tfa.self_qkv_dispatch(x, 24, g[0], g[1])
    assert tfa.joint_qkv_attention.launches == before + 1
    for b in range(2):
        xb = x[b:b + 1]
        want = tfa.joint_qkv_attention_bf16_reference(xb, xb[:, :0], 24,
                                                      *g[:2], *g[:2])
        tol = tfa.joint_qkv_attention_bf16_tolerance(xb, xb[:, :0], 24,
                                                     *g[:2], *g[:2], want)
        diff = (got[b:b + 1].float() - want).abs()
        assert bool((diff <= tol).all()), (b, diff.max().item())


@pytest.mark.cuda
def test_k4_refuses_what_it_does_not_take(cuda):
    x, c, g = _joint(1, 16, 8, 2, seed=2)
    x, c = x.to(cuda), c.to(cuda)
    g = [t.to(cuda) for t in g]
    with pytest.raises(ValueError, match="contiguous"):
        tfa.joint_qkv_attention(x[:, ::2], c, 2, *g)
    with pytest.raises(ValueError, match="aligned"):   # offset of 4 bytes
        tfa.joint_qkv_attention(
            x, torch.zeros(1 + c.numel(), device=cuda)[1:].view(c.shape), 2,
            *g)
    with pytest.raises(ValueError, match="differ"):
        tfa.joint_qkv_attention(x, c.to(torch.bfloat16), 2, *g)
    with pytest.raises(ValueError, match="3\\*D"):
        tfa.joint_qkv_attention(x, c[..., :-3], 2, *g)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tfa.joint_qkv_attention(x, c, 4, *(t[:32] for t in g))
    # the pre-pass alone refuses the same
    with pytest.raises(ValueError, match="contiguous"):
        tfa.joint_qk_norm(x[:, ::2], c, 2, *g)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tfa.joint_qk_norm(x, c, 4, *(t[:32] for t in g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,H,Sq,Sk,hd,causal", [
    ("mid", 6, 24, 1613, 1613, 64, False),    # SD3-medium joint, 512^2
    ("mid", 8, 16, 1374, 1374, 64, False),    # DINOv2 ViT-L at 518^2
    ("mid", 2, 3, 700, 1030, 64, False),      # ragged, Sq != Sk
    ("mid", 1, 2, 641, 4096, 80, False), ("mid", 2, 1, 5, 2000, 128, False),
    ("flash", 6, 24, 4685, 4685, 64, False),  # SD3.5-medium joint, 1024^2
    ("flash", 2, 16, 2048, 2048, 64, True),   # causal, square
    ("flash", 2, 3, 129, 4097, 128, False),   # ragged, Sq != Sk
    ("flash", 1, 2, 300, 300, 16, True),
    ("flash", 70000, 1, 8, 8, 16, False),     # B*H past a grid dim's 65535
    # one or two heads across many 64-key tiles (f32: the error of 26-74
    # tiles' sums), every head_dim class of the f32 tile (hd <= 64 takes
    # P.V on wgmma, hd 80 and 128 on mma.sync)
    ("mid", 1, 2, 1613, 1613, 64, False), ("mid", 2, 1, 1613, 700, 64, False),
    ("mid", 1, 2, 1000, 1613, 16, False),
    ("flash", 1, 1, 4685, 4685, 64, False),
    ("flash", 1, 2, 2048, 2048, 64, True),
    ("flash", 1, 2, 777, 4685, 80, False),
    ("flash", 1, 1, 2048, 2048, 128, True),
    ("flash", 1, 2, 2100, 2100, 16, True)])
def test_k5_k6_match_plain(cuda, name, B, H, Sq, Sk, hd, causal, dtype):
    """K5 mid_attention and K6 flash_attention.  f32 (the three-pass
    TF32 tile) as K3: 2e-5 abs.  bf16 rounds P to bf16 on the tensor
    cores: ``flash_attention_bf16_tolerance``."""
    fn = getattr(tfa, f"{name}_attention")
    plain = getattr(tfa, f"{name}_attention_reference")
    flags = (causal,) if name == "flash" else ()
    q = _bhsd(B, H, Sq, hd, 12).to(cuda, dtype)
    k, v = (_bhsd(B, H, Sk, hd, s).to(cuda, dtype) for s in (13, 14))
    before = fn.launches
    got = fn(q, k, v, *flags)
    assert fn.launches == before + 1
    want = plain(q, k, v, *flags)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, Sq, hd)
    diff = (got.float() - want.float()).abs()
    tol = (2e-5 if dtype == torch.float32 else
           tfa.flash_attention_bf16_tolerance(q, k, v, want, causal))
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", [
    (2, 3, 1, 1, 64, False), (1, 2, 1, 300, 64, False),    # Sq = 1
    (2, 2, 100, 65, 32, False),         # one key past a 64-key tile
    (1, 2, 70, 4097, 64, False),        # ... and past 4096
    (2, 2, 300, 300, 64, True),         # causal, ragged last tile
    (1, 4, 2048, 2048, 128, True),      # causal, hd 128 (a 3-stage ring)
    (1, 2, 333, 333, 16, True), (2, 3, 200, 129, 32, False),
    (1, 2, 77, 190, 48, False), (2, 1, 129, 513, 80, False),
    (1, 2, 150, 150, 96, True), (1, 1, 64, 64, 112, False),
    (1, 3, 130, 260, 128, False),
    (70000, 1, 8, 8, 64, False)])       # B*H past a grid dim's 65535
def test_k6_bf16_tensor_core_tile_edges(cuda, B, H, Sq, Sk, hd, causal):
    """The edges of K6's bf16 tile (ragged Sq and Sk on both sides of a
    tile, the causal diagonal, every head_dim the wrapper takes, a large
    1-D grid) within ``flash_attention_bf16_tolerance``."""
    q = _bhsd(B, H, Sq, hd, 15).to(cuda, torch.bfloat16)
    k, v = (_bhsd(B, H, Sk, hd, s).to(cuda, torch.bfloat16) for s in (16, 17))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal)
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q, k, v, causal)
    tol = tfa.flash_attention_bf16_tolerance(q, k, v, want, causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, Sq, hd)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,H,Sq,Sk,causal", [
    ("mid", 2, 3, 1, 1, False), ("mid", 1, 2, 1, 300, False),   # Sq = 1
    ("flash", 2, 3, 1, 1, False), ("flash", 1, 2, 1, 300, False),
    ("mid", 2, 2, 100, 65, False),      # one key past a 64-key tile
    ("flash", 2, 2, 100, 65, False),
    ("mid", 2, 2, 200, 129, False),     # one key past a 128-key tile
    ("flash", 2, 2, 200, 129, False),
    ("mid", 1, 2, 70, 4096, False),     # K5's most keys
    ("flash", 1, 2, 70, 4097, False),   # ... and past them
    ("flash", 2, 2, 300, 300, True),    # causal, ragged last tile
    ("flash", 1, 2, 2048, 2048, True),
    ("mid", 2, 1, 1613, 700, False),    # ragged Sq != Sk
    ("flash", 1, 3, 333, 1000, False),
    ("mid", 70000, 1, 8, 8, False),     # B*H past 65,535 (the tensor
    ("flash", 70000, 1, 8, 8, False)])  # map's BH dimension, the grid)
def test_k5_k6_bf16_tma_tile_edges(cuda, name, B, H, Sq, Sk, causal):
    """The edges of the TMA tile (K5 and K6 in bf16 at head_dim 64):
    ragged Sq and Sk on both sides of a 64- and a 128-key tile, the causal
    diagonal, a large B*H, within ``flash_attention_bf16_tolerance``."""
    fn = getattr(tfa, f"{name}_attention")
    plain = getattr(tfa, f"{name}_attention_reference")
    flags = (causal,) if name == "flash" else ()
    q = _bhsd(B, H, Sq, 64, 24).to(cuda, torch.bfloat16)
    k, v = (_bhsd(B, H, Sk, 64, s).to(cuda, torch.bfloat16) for s in (25, 26))
    before = fn.launches
    got = fn(q, k, v, *flags)
    assert fn.launches == before + 1
    want = plain(q, k, v, *flags)
    tol = tfa.flash_attention_bf16_tolerance(q, k, v, want, causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, Sq, 64)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
def test_long_attention_routes_to_k5_and_k6(cuda):
    """SD3-medium's composed joint attention reaches K5, SD3.5-medium's at
    1024^2 reaches K6, and a causal sequence past 640 keys with small
    logits takes the plain composition (no kernel), as in the JAX
    package."""
    n5, n6 = tfa.mid_attention.launches, tfa.flash_attention.launches
    a = torch.zeros(6, 24, 1613, 64, device=cuda, dtype=torch.bfloat16)
    tfa.attention(a, a, a)
    assert (tfa.mid_attention.launches, tfa.flash_attention.launches) == (
        n5 + 1, n6)
    b = torch.zeros(6, 24, 4685, 64, device=cuda, dtype=torch.bfloat16)
    tfa.attention(b, b, b)
    assert (tfa.mid_attention.launches, tfa.flash_attention.launches) == (
        n5 + 1, n6 + 1)
    c = torch.zeros(1, 2, 700, 64, device=cuda)
    torch.testing.assert_close(tfa.attention(c, c, c, causal=True),
                               tfa.reference_attention(c, c, c, causal=True))
    assert (tfa.mid_attention.launches, tfa.flash_attention.launches) == (
        n5 + 1, n6 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 261, 1024), (32, 261, 1024),
                                   (2, 77, 1280), (5, 100), (2, 7, 37)])
def test_k7_matches_plain(cuda, shape, dtype):
    """Rows of mean 1 and std 3, unit-scale affine parameters.  f32: the
    same two-pass statistics summed in another order, 1e-5 abs on outputs
    of a few units.  bf16: 1e-5 plus one bf16 ulp at the output's
    magnitude."""
    rng = np.random.default_rng(18)
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 1).astype(
        np.float32)).to(cuda, dtype)
    g, b = (torch.from_numpy(rng.normal(size=shape[-1]).astype(np.float32)
                             ).to(cuda) for _ in range(2))
    before = tln.layer_norm.launches
    got = tln.layer_norm(x, g, b)
    assert tln.layer_norm.launches == before + 1
    want = tln.layer_norm_reference(x, g, b)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    diff = (got.float() - want.float()).abs()
    tol = 1e-5 + (0 if dtype == torch.float32 else bf16_ulp(want))
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D,offset", [
    (9, 1, 0),          # D 1: the generic path
    (7, 1022, 0),       # D not a multiple of either vector width
    (5, 1020, 0),       # f32: a part-filled last chunk; bf16: generic
    (6, 768, 0),        # chunks past D masked
    (3, 4096, 0),       # the widest vector path
    (2, 4104, 0),       # past it: generic
    (4, 1024, 1)])      # a view one element off 16-byte alignment
def test_k7_edge_widths(cuda, rows, D, offset, dtype):
    """K7 at the edges of its vector path, as ``test_k7_matches_plain``:
    a misaligned view or a D the 16-byte loads do not divide takes the
    generic path of the same kernel, neither refused nor copied."""
    rng = np.random.default_rng(D + offset)
    buf = torch.from_numpy((rng.normal(size=offset + rows * D) * 3 + 1
                            ).astype(np.float32)).to(cuda, dtype)
    x = buf[offset:].view(rows, D)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset > 0)
    g, b = (torch.from_numpy(rng.normal(size=D).astype(np.float32)).to(cuda)
            for _ in range(2))
    before = tln.layer_norm.launches
    got = tln.layer_norm(x, g, b)
    assert tln.layer_norm.launches == before + 1
    want = tln.layer_norm_reference(x, g, b)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = 1e-5 + (0 if dtype == torch.float32 else bf16_ulp(want))
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,CO,act", [
    (1, 80, 80, 160, 160, "silu"),      # YOLOv8x C2f widths
    (2, 40, 40, 320, 320, "silu"),
    (1, 20, 20, 640, 640, "silu"),
    (2, 7, 9, 20, 36, "none"), (1, 5, 3, 3, 70, "silu")])
def test_k8_matches_plain(cuda, B, H, W, C, CO, act, dtype):
    """Weights N(0, 1/(9C)), so outputs are O(1).  f32: the same products
    summed in another order, 1e-4 of max |out|.  bf16: that plus one bf16
    ulp at the output's magnitude."""
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(
        np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.normal(size=(9, C, CO)) / np.sqrt(9 * C)
                          ).astype(np.float32)).to(cuda, dtype)
    bias = torch.from_numpy(rng.normal(size=CO).astype(np.float32)).to(cuda)
    before = tconv.conv3x3_s1.launches
    got = tconv.conv3x3_s1(x, w, bias, act)
    assert tconv.conv3x3_s1.launches == before + 1
    want = tconv.conv3x3_s1_reference(x, w, bias, act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, CO)
    diff = (got.float() - want.float()).abs()
    tol = 1e-4 * want.float().abs().max() + (
        0 if dtype == torch.float32 else bf16_ulp(want))
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("B,H,W,C,CO", [
    (1, 7, 9, 160, 160),     # 63 pixels: less than one 128-pixel tile
    (1, 13, 11, 320, 320),   # 143: one tile and a ragged one
    (1, 6, 5, 640, 640),
    (2, 7, 9, 20, 36),       # C 20: 8-byte copies; CO 36: an N tail
    (1, 5, 3, 3, 70),        # C 3: element loads; CO 70
    (1, 10, 10, 160, 70),    # gcd 10: 4-byte copies
    (2, 9, 1, 160, 36),      # W 1
    (1, 1, 17, 20, 70),      # H 1
    (3, 1, 1, 3, 160)])      # H = W = 1
def test_k8_bf16_tensor_core_edges(cuda, B, H, W, C, CO, act):
    """The edges of K8's bf16 implicit GEMM (M and N tails, each copy
    width, one-pixel images): as ``test_k8_matches_plain``, 1e-4 of max
    |out| plus one bf16 ulp (bf16 products are exact in f32; only the
    order of the sums differs)."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(9, C, CO)) / np.sqrt(9 * C)
                          ).astype(np.float32)).to(cuda, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=CO).astype(np.float32)).to(cuda)
    before = tconv.conv3x3_s1.launches
    got = tconv.conv3x3_s1(x, w, bias, act)
    assert tconv.conv3x3_s1.launches == before + 1
    want = tconv.conv3x3_s1_reference(x, w, bias, act)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, CO)
    diff = (got.float() - want.float()).abs()
    tol = 1e-4 * want.float().abs().max() + bf16_ulp(want)
    assert bool((diff <= tol).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,CO,offset", [
    (1, 7, 9, 160, 160, 0),    # 63 pixels: less than one 128-pixel tile
    (1, 13, 11, 320, 320, 0),  # 143: one tile and a ragged one; N 3 tiles
    (2, 7, 9, 20, 36, 0),      # C 20: 16-byte copies; CO 36: an N tail
    (1, 10, 10, 6, 70, 0),     # 8-byte copies; CO 70
    (1, 5, 3, 3, 70, 0),       # C 3: 4-byte copies
    (1, 9, 9, 40, 200, 0),     # CO 200: a part-filled second N tile
    (1, 1, 1, 33, 17, 0),      # one pixel, odd widths
    (3, 4, 5, 64, 64, 1)])     # x one float off 16-byte alignment
def test_k8_f32_tensor_core_edges(cuda, B, H, W, C, CO, offset):
    """The edges of K8's f32 implicit GEMM on the tensor cores (three TF32
    products per product): M and N tails, each copy width, a warp past
    CO, a misaligned view; within 1e-4 of max |out|, the f32 bound."""
    rng = np.random.default_rng(21 + C)
    n = B * H * W * C
    buf = torch.from_numpy(rng.normal(size=offset + n).astype(np.float32)
                           ).to(cuda)
    x = buf[offset:].view(B, H, W, C)
    w = torch.from_numpy((rng.normal(size=(9, C, CO)) / np.sqrt(9 * C)
                          ).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(size=CO).astype(np.float32)).to(cuda)
    for act in ("silu", "none"):
        before = tconv.conv3x3_s1.launches
        got = tconv.conv3x3_s1(x, w, bias, act)
        assert tconv.conv3x3_s1.launches == before + 1
        want = tconv.conv3x3_s1_reference(x, w, bias, act)
        torch.cuda.synchronize()
        assert got.shape == (B, H, W, CO)
        diff = (got - want).abs()
        assert bool((diff <= 1e-4 * want.abs().max()).all()), (
            act, diff.max().item())


@pytest.mark.cuda
def test_k8_refuses_misaligned_bf16(cuda):
    x = torch.zeros(1 + 2 * 4 * 4 * 8, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(9, 8, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):   # offset of 2 bytes
        tconv.conv3x3_s1(x[1:].view(2, 4, 4, 8), w, torch.zeros(8))


@pytest.mark.cuda
def test_clip_attention_routes_to_k3(cuda):
    """hd 80 and causal inputs reach K3 and not K1; ViT-L's shape reaches
    K1; past 640 keys a non-causal call reaches K5 (DINOv2 at 518^2)."""
    n1, n3 = tfa.short_attention_qkv.launches, tfa.short_attention.launches
    n5 = tfa.mid_attention.launches
    tfa.attention_from_qkv(torch.zeros(2, 257, 3 * 16 * 80, device=cuda), 16)
    tfa.attention_from_qkv(torch.zeros(2, 77, 3 * 16 * 64, device=cuda), 16,
                           causal=True)
    assert tfa.short_attention.launches == n3 + 2
    assert tfa.short_attention_qkv.launches == n1
    tfa.attention_from_qkv(torch.zeros(2, 261, 3 * 16 * 64, device=cuda), 16)
    assert tfa.short_attention_qkv.launches == n1 + 1
    out = tfa.attention_from_qkv(
        torch.zeros(1, 1374, 3 * 16 * 64, device=cuda), 16)
    assert tfa.mid_attention.launches == n5 + 1
    assert out.shape == (1, 1374, 16 * 64)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=cuda)
    q = torch.zeros(2, 2, 40, 64, device=cuda)
    with pytest.raises(ValueError, match="at most 4096"):
        big = torch.zeros(1, 1, 4097, 64, device=cuda)
        tfa.mid_attention(q[:1, :1], big, big)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.flash_attention(q, q[:, :, :20].contiguous(),
                            q[:, :, :20].contiguous(), causal=True)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tfa.flash_attention(*(torch.zeros(1, 1, 8, 40, device=cuda),) * 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.mid_attention(q, q.transpose(0, 1), q)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.short_attention(q[:, :, ::2], q, q)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.short_attention(q, q.transpose(0, 1), q)
    with pytest.raises(ValueError, match="aligned"):
        tfa.short_attention(q, torch.zeros(1 + q.numel(), device=cuda)[1:]
                            .view(q.shape), q)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.short_attention(q, q[:, :, :20].contiguous(),
                            q[:, :, :20].contiguous(), causal=True)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tfa.short_attention(*(torch.zeros(1, 1, 8, 40, device=cuda),) * 3)
    with pytest.raises(NotImplementedError):
        tfa.short_attention_qkv(torch.zeros(1, 8, 3 * 160, device=cuda), 1)
    with pytest.raises(TypeError):
        tfa.short_attention_qkv(qkv.half(), heads=2)
    with pytest.raises(ValueError, match="aligned"):     # offset of 4 bytes
        tfa.short_attention_qkv(
            torch.zeros(1 + 8 * 3 * 2 * 64, device=cuda)[1:].view(
                1, 8, 3 * 2 * 64), heads=2)
    with pytest.raises(ValueError, match="aligned"):
        tsim.max_cosine_per_voxel(
            torch.zeros(1 + 8 * 16, device=cuda)[1:].view(8, 16),
            torch.ones(8, device=cuda),
            torch.ones(4, dtype=torch.int32, device=cuda),
            torch.ones(16, device=cuda))
    # int8 rows take the Q-query kernel at Q = 1: zero codes score 0
    out = tsim.max_cosine_per_voxel(
        torch.zeros(8, 16, dtype=torch.int8, device=cuda),
        torch.ones(8, device=cuda),
        torch.ones(4, dtype=torch.int32, device=cuda),
        torch.ones(16, device=cuda))
    assert torch.equal(out.cpu(), torch.zeros(4))
    with pytest.raises(NotImplementedError, match="float16"):
        tsim.max_cosine_per_voxel(
            torch.zeros(8, 16, dtype=torch.float16, device=cuda),
            torch.ones(8, device=cuda),
            torch.ones(4, dtype=torch.int32, device=cuda),
            torch.ones(16, device=cuda))


@pytest.mark.cuda
def test_slice_on_card_matches_cpu(cuda):
    """build_step + query_step on the card (K1 in every layer, K2 in the
    scan) against the same steps on the CPU (plain versions), with the
    same frames, weights and injected draws: equal integer store, equal
    top-K scores within 1e-4 (f32 throughout)."""
    cfg = small_test_config()
    vcfg = tv.ViTConfig(img_size=28, patch_size=14, dim=32, depth=2,
                        heads=2, num_registers=1)
    rng = np.random.default_rng(0)
    B, H, W = 4, cfg.sensor.height, cfg.sensor.width
    rgb = rng.integers(0, 255, size=(B, H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0.3, 4.0, size=(B, H, W)).astype(np.float32)
    poses = np.zeros((B, 7), np.float32)
    poses[:, 3:] = rng.normal(size=(B, 4))
    P = H * W // cfg.memory.depth_sample_rate
    pix = rng.integers(0, H * W, size=(B, P))
    repl = rng.integers(0, cfg.memory.cache_size, size=B * P)
    cpu_model = tv.init_params(vcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    card_model = tv.ViT(vcfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())

    out = {}
    for dev, model in (("cpu", cpu_model), (cuda, card_model)):
        build = tpipe.make_build_step(cfg, vcfg)
        query = tpipe.make_query_step(cfg, vcfg)
        t = [torch.from_numpy(a).to(dev) for a in (rgb, depth, poses, pix,
                                                   repl)]
        (state, _), _ = build((init_store(cfg.memory, device=dev), None),
                              model, *t[:3], pix=t[3], repl_idx=t[4])
        pos, sc = query(state, model, t[0][:2], top_k=16)
        out[str(dev)] = (state, pos.cpu().numpy(), sc.cpu().numpy())
    (cs, cpos, csc), (gs, gpos, gsc) = out["cpu"], out["cuda"]
    V = cfg.memory.voxel_capacity
    assert int(gs.num_voxels) == int(cs.num_voxels) > 50
    for f in ("slot_pos", "feat_count"):
        assert torch.equal(getattr(gs, f)[:V].cpu(), getattr(cs, f)[:V]), f
    np.testing.assert_allclose(gsc, csc, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_yolo_forward_takes_k8_for_every_f32_3x3_stride1_conv(cuda):
    """YOLO_TEST's widths at 128^2 on the card launch K8 once per 3x3
    stride-1 conv (36: 12 in the backbone's C2f blocks, 3 in each of the
    four C2fAttn blocks, 4 in each of the three heads), the int8-neck
    tree only the backbone's 12; the logits hold the CPU's (plain
    versions) within 1e-4 of each level's max |logit| (K8's f32 bound,
    1e-4 of max |out| a conv, on logits of O(1)).  128^2, not YOLO_TEST's
    64^2: at 64^2 the stride-32 level of 2 frames has 8 pixels, and
    torch._int_mm takes more than 16 rows."""
    import dataclasses
    from bsc_nav_tpu_torch.models import yolo_world as Y
    cfg = dataclasses.replace(Y.YOLO_TEST, img_size=128)
    cpu = Y.init_params(cfg, torch.Generator().manual_seed(0),
                        text_dim=48, device="cpu")
    for hp in cpu["head"]:
        hp["logit_bias"] = torch.tensor(0.0)
    to = lambda t: (t.to(cuda) if isinstance(t, torch.Tensor) else
                    {k: to(v) for k, v in t.items()} if isinstance(t, dict)
                    else [to(v) for v in t])
    card = to(cpu)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(size=(2, 128, 128, 3)).astype(
        np.float32))
    text = torch.from_numpy(rng.normal(size=(5, 48)).astype(np.float32))
    text = text / text.norm(dim=-1, keepdim=True)
    want = Y.forward(cpu, img, text, cfg)
    for params, n in ((card, 36), (Y.quantize_params(card), 12)):
        before = tconv.conv3x3_s1.launches
        got = Y.forward(params, img.to(cuda), text.to(cuda), cfg)
        torch.cuda.synchronize()
        assert tconv.conv3x3_s1.launches - before == n
        if n == 36:
            for (gb, gc), (wb, wc) in zip(got, want):
                for g, w in ((gb, wb), (gc, wc)):
                    assert float((g.cpu() - w).abs().max()) <= (
                        1e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_conv2d_same_stays_f32_with_the_tf32_flag_on(cuda):
    """cuDNN's route turns TF32 off for its call: with the process flag on
    (PyTorch's default), a 1x1 and a 3x3 stride-2 f32 conv hold an f32
    bound (1e-5 relative to the terms' magnitudes) that one TF32 product
    (~5e-4) would break; the flag is left as it was."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 20, 20, 96)).astype(
        np.float32)).to(cuda)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for k, s in ((1, 1), (3, 2)):
            w = torch.from_numpy((rng.normal(size=(k, k, 96, 64))
                                  / np.sqrt(k * k * 96)).astype(
                np.float32)).to(cuda)
            got = tconv.conv2d_same(x, w, s).double().cpu()
            want = tconv.conv2d_same(x.double().cpu(), w.double().cpu(), s)
            mag = tconv.conv2d_same(x.double().abs().cpu(),
                                    w.double().abs().cpu(), s)
            assert float(((got - want).abs() / mag).max()) < 1e-5
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv_q8_on_the_card_equals_the_cpu(cuda, k, stride):
    """conv_q8 (im2col + torch._int_mm on the card, the exact float64
    product on the CPU): equal codes, exact int32 sums, the same f32
    epilogue: equal outputs."""
    from bsc_nav_tpu_torch.ops import quant as tq
    rng = np.random.default_rng(k + stride)
    x = torch.from_numpy(rng.normal(size=(2, 10, 10, 32)).astype(np.float32))
    p = tq.quantize_conv_weight({"w": torch.from_numpy(
        (rng.normal(size=(k, k, 32, 24)) / np.sqrt(k * k * 32)).astype(
            np.float32))})
    want = tq.conv_q8(x, p, stride)
    got = tq.conv_q8(x.to(cuda), {n: t.to(cuda) for n, t in p.items()},
                     stride)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 3072), (3, 3, 64, 80)])
def test_weight_quantize_on_the_card_equals_the_cpu(cuda, shape):
    """quantize_weight / quantize_conv_weight on the card give the CPU's
    leaves bit for bit: the scale is a true division on both
    (``quant.weight_scale``), where a CUDA division by the Python scalar
    127.0 is a product with its reciprocal."""
    from bsc_nav_tpu_torch.ops import quant as tq
    fn = tq.quantize_weight if len(shape) == 2 else tq.quantize_conv_weight
    rng = np.random.default_rng(len(shape))
    w = torch.from_numpy((rng.normal(size=shape) * 0.02).astype(np.float32))
    want = fn({"w": w})
    got = fn({"w": w.to(cuda)})
    for k in ("w_q", "w_s"):
        assert torch.equal(got[k].cpu(), want[k]), k


# ---------------------------------------------------------------------------
# the surprise policy, the forgetting pass and spilled segments on the card
# ---------------------------------------------------------------------------

def _surprise_cfg(exact):
    import dataclasses
    cfg = small_test_config()
    return cfg.replace(memory=dataclasses.replace(
        cfg.memory, voxel_capacity=(1 << 10) - 8, replacement="surprise",
        surprise_exact=exact, surprise_threshold=0.9))


def _surprise_frames(cfg, seed=20):
    """Three frames at random poses and depths, twice (other pixel draws,
    the tokens moved by noise), with the pixel draws."""
    rng = np.random.default_rng(seed)
    B, H, W = 3, cfg.sensor.height, cfg.sensor.width
    P = -(-H * W // cfg.memory.depth_sample_rate)
    rgb = rng.integers(0, 255, size=(B, H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0.2, 4.0, size=(B, H, W)).astype(np.float32)
    poses = np.zeros((B, 7), np.float32)
    poses[:, :3] = rng.uniform(-1, 1, size=(B, 3))
    q = rng.normal(size=(B, 4))
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    tokens = rng.normal(size=(B, 2, 2, cfg.memory.token_dim)).astype(
        np.float32)
    moved = tokens + rng.normal(size=tokens.shape).astype(np.float32)
    return [(rgb, depth, poses, t, rng.integers(0, H * W, size=(B, P)))
            for t in (tokens, moved)]


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_surprise_ingest_on_the_card_matches_cpu(cuda, exact, dtype):
    """The surprise ingest on the card (TF32 on in the caller: the cosines
    stay full f32) against the CPU on the same frames and draws: equal
    integer fields and observation counts, rows and running sums within
    1e-5 relative.  Each gate decision of the CPU run lies more than 1e-5
    from the threshold, beyond the two devices' cosine differences."""
    from bsc_nav_tpu_torch.memory import ingest as ting
    cfg = _surprise_cfg(exact)
    thr = cfg.memory.surprise_threshold
    gate = ting._surprise
    gaps = []

    def checked(state, token, tok_norm, nslot, n_ok, judged, mem):
        novel = gate(state, token, tok_norm, nslot, n_ok, judged, mem)
        v = novel[judged]
        v = v[torch.isfinite(v)].double().cpu()
        gaps.append(float((v - thr).abs().min()) if len(v) else np.inf)
        return novel

    stores = {}
    old = torch.backends.cuda.matmul.allow_tf32
    ting._surprise = checked
    try:
        for dev in ("cpu", cuda):
            torch.backends.cuda.matmul.allow_tf32 = True
            state = init_store(cfg.memory, dtype, device=dev)
            for rgb, depth, poses, tokens, pix in _surprise_frames(cfg):
                state, _ = ting.ingest_frames(
                    state, *(torch.from_numpy(a).to(dev)
                             for a in (rgb, depth, poses, tokens)),
                    None, cfg, pix=torch.from_numpy(pix).to(dev))
            stores[str(dev)] = state
    finally:
        ting._surprise = gate
        torch.backends.cuda.matmul.allow_tf32 = old
    assert min(gaps) > 1e-5
    cpu, card = stores["cpu"], stores[str(cuda)]
    n, K = int(cpu.num_voxels), cfg.memory.cache_size
    assert n > 100
    G = cfg.memory.grid_size
    for f, rows in (("slot_pos", n), ("feat_count", n), ("slot_map", -1),
                    ("cv_map", G * G), ("max_height", G * G),
                    ("num_voxels", None), ("feat_obs", n)):
        a, b = getattr(cpu, f), getattr(card, f).cpu()
        if rows is not None:
            a, b = a[:rows], b[:rows]
        assert torch.equal(a, b), f
    for f, rows in (("feats", n * K), ("feat_norm", n * K),
                    ("feat_sum", n)):
        a = getattr(cpu, f)[:rows].float()
        b = getattr(card, f)[:rows].float().cpu()
        assert torch.allclose(b, a, rtol=1e-5, atol=1e-6), f


def _dup_rows(V1, K, D, n, seed):
    """n voxels of K rows, some rows near-duplicates of an earlier one
    (cosine > 0.999), the rest random; random counts."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(V1, K, D)).astype(np.float32)
    dup = rng.uniform(size=(V1, K)) < 0.4
    src = rng.integers(0, K, size=(V1, K))
    for v, k in zip(*np.nonzero(dup)):
        f[v, k] = f[v, min(src[v, k], k)] * rng.uniform(0.5, 2.0) + (
            1e-3 * rng.normal(size=D))
    counts = rng.integers(0, K + 1, size=V1).astype(np.int32)
    counts[n:] = 0
    f[np.arange(K)[None, :] >= counts[:, None]] = 0.0
    return f.reshape(V1 * K, D), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_forgetting_pass_on_the_card_matches_cpu(cuda, dtype):
    """forgetting_pass on the card (TF32 on in the caller, chunks of 301
    voxels) against the CPU: equal counts; rows, norms and distances
    within 1e-5 relative; int8 codes within 1 and scales within 1e-6
    relative; 1.0 scales and zero rows past every count."""
    from bsc_nav_tpu_torch.memory import replacement as trep
    V1, K, D = 1608, 10, 1024
    f, counts = _dup_rows(V1, K, D, 1500, seed=3)
    state = tstore.VoxelStoreState(**{
        k: v for k, v in vars(init_store(
            small_test_config().memory, device="cpu")).items()})
    state.feat_count = torch.from_numpy(counts.copy())
    state.feat_dist = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 9, size=V1 * K).astype(np.float32))
    rows = torch.from_numpy(f)
    if dtype == torch.int8:
        state.feats, state.feat_norm, state.feat_scale = (
            tstore.quantize_feat_rows(rows, rows.norm(dim=1)))
    else:
        state.feats = rows.to(dtype)
        state.feat_norm = state.feats.float().norm(dim=1)
        state.feat_scale = torch.zeros(1)
    card = tstore.VoxelStoreState(**{k: v.to(cuda, copy=True) for k, v in
                                     vars(state).items()})
    old_chunk, old_tf32 = (trep.CHUNK_ELEMENTS,
                           torch.backends.cuda.matmul.allow_tf32)
    try:
        trep.CHUNK_ELEMENTS = 301 * K * D
        torch.backends.cuda.matmul.allow_tf32 = True
        want = trep.forgetting_pass(state)
        got = trep.forgetting_pass(card)
        torch.cuda.synchronize()
    finally:
        trep.CHUNK_ELEMENTS = old_chunk
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    assert torch.equal(got.feat_count.cpu(), want.feat_count)
    assert int((want.feat_count < torch.from_numpy(counts)).sum()) > 200
    if dtype == torch.int8:
        diff = (got.feats.cpu().int() - want.feats.int()).abs()
        assert int(diff.max()) <= 1
        assert torch.allclose(got.feat_scale.cpu(), want.feat_scale,
                              rtol=1e-6, atol=0)
    else:
        assert torch.allclose(got.feats.cpu().float(), want.feats.float(),
                              rtol=1e-5, atol=1e-6)
    for f_ in ("feat_norm", "feat_dist"):
        assert torch.allclose(getattr(got, f_).cpu(), getattr(want, f_),
                              rtol=1e-5, atol=1e-6), f_


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [None, "int8"])
def test_spilled_segment_scans_on_k2_and_k2b(cuda, freeze):
    """A segment of 203 voxels (its n x K rows unpadded) frozen and spilled
    to pinned host memory, then queried: the rows stream back to the card
    and take K2 (f32 rows) or K2b at Q 1 (int8 rows), once a query; the
    top-16 against the plain scan of the same host rows, within 2e-5."""
    import dataclasses
    from bsc_nav_tpu_torch.memory import segments as tseg
    cfg = small_test_config()
    mem = dataclasses.replace(cfg.memory, voxel_capacity=248)
    seg = tseg.SegmentedStore(mem, max_device_segments=0,
                              freeze_dtype=freeze, device=cuda)
    f, n, c, _ = _store(203, mem.cache_size, mem.token_dim, seed=9)
    rng = np.random.default_rng(9)
    s = seg.state
    rows = 203 * mem.cache_size
    s.feats[:rows], s.feat_norm[:rows] = f.to(cuda), n.to(cuda)
    s.feat_count[:203] = c.to(cuda)
    s.slot_pos[:203] = torch.from_numpy(rng.integers(
        0, 60, size=(203, 3)).astype(np.int32)).to(cuda)
    s.num_voxels.fill_(203)
    seg.rotate_threshold = 200
    assert seg.rotate_if_full() and len(seg.host_segments) == 1
    host = seg.host_segments[0]
    assert host["feats"].shape[0] == rows and host["feats"].is_pinned()
    assert host["feats"].dtype == (torch.int8 if freeze else torch.float32)
    q = torch.from_numpy(_unit_queries(1, mem.token_dim, 2, "cpu")[0]
                         .numpy())
    n2, n2b = (tsim.max_cosine_per_voxel.launches,
               tsim.max_cosine_per_voxel_batch.launches)
    got = seg._localize_host_segment(host, q.to(cuda), 16)
    torch.cuda.synchronize()
    assert (tsim.max_cosine_per_voxel.launches - n2,
            tsim.max_cosine_per_voxel_batch.launches - n2b) == (
                (0, 1) if freeze else (1, 0))
    want = seg._localize_host_segment(
        {k: (v.clone() if torch.is_tensor(v) else v)
         for k, v in host.items()}, q, 16)
    np.testing.assert_allclose(got[1], want[1], atol=2e-5, rtol=0)
    kth = want[1].min()
    assert ({tuple(p) for p, s_ in zip(*got) if s_ > kth + 4e-5}
            == {tuple(p) for p, s_ in zip(*want) if s_ > kth + 4e-5})


@pytest.mark.cuda
def test_fake_objnav_episode_on_the_card_matches_cpu(cuda, tmp_path):
    """The drivers' fake world built on the card and on the CPU, the card's
    encoder holding the CPU one's weights: episode 0 ('bed'), which stage 1
    (the host colour detector, scorer and long-term memory) decides, walks
    the same actions and writes the same nav_log and CSV row; the card's
    path launched K3 (the drivers' ViT has head_dim 16), the CPU's
    nothing."""
    import argparse
    from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot
    from bsc_nav_tpu_torch.drivers import common as DC
    from bsc_nav_tpu_torch.drivers import setup as DS
    runs, params = {}, None
    for device in ("cpu", "cuda"):
        p = argparse.ArgumentParser()
        DS.add_common_args(p)
        d = tmp_path / device
        args = p.parse_args(["--device", device, "--memory-root", str(d)])
        cfg, bench, mem, extras = DS.build_world(args, "objnav")
        if params is None:
            params = mem.perception.vit_params.state_dict()
        else:
            mem.perception.vit_params.load_state_dict(params)
        robot = ObjectNavRobot(mem, bench, llm_client=extras["llm"],
                               matcher=extras["matcher"])
        k3 = tfa.short_attention.launches
        recs = DC.run_episodes(
            robot, bench, 1,
            lambda r, ep: r.move2textprompt(f"a {ep.object_category}"),
            lambda r, b, ep: {**DC.nav_telemetry(r),
                              **{k: v for k, v in b.get_metrics().items()
                                 if k != "top_down_map"}},
            str(d / "r.csv"), log_root=str(d / "tmp"),
            ensure_memory=DS.ensure_memory_fake)
        runs[device] = (robot.action_hist, dict(robot.nav_log),
                        recs[0].metrics, (d / "r.csv").read_text(),
                        tfa.short_attention.launches - k3,
                        int(mem.state.num_voxels))
    cpu, card = runs["cpu"], runs["cuda"]
    assert card[1]["working_memory_query"] == 0 < card[1]["long_memory_query"]
    assert card[:4] == cpu[:4]
    assert cpu[4] == 0 < card[4]
    assert card[5] > 300 and cpu[5] > 300
