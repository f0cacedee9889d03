"""The port's CUDA kernels (K1 short_attention_qkv, K2 max_cosine_per_voxel)
against their plain PyTorch versions.

This file imports no JAX, so the card tests also run where JAX is not
installed.  On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX.)  Without a card the
``cuda`` tests skip; the CPU tests here check the dispatch rule: a CPU
tensor takes the plain version and launches nothing.
"""

import pathlib

import numpy as np
import pytest
import torch

from bsc_nav_tpu.config import small_test_config
from bsc_nav_tpu_torch.memory import pipeline as tpipe
from bsc_nav_tpu_torch.memory.store import init_store
from bsc_nav_tpu_torch.models import vit as tv
from bsc_nav_tpu_torch.ops import _build
from bsc_nav_tpu_torch.ops import flash_attention as tfa
from bsc_nav_tpu_torch.ops import similarity as tsim


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
    torch.testing.assert_close(tsim.max_cosine_per_voxel(*store),
                               tsim.reference_max_cosine(*store))
    assert tfa.short_attention_qkv.launches == n1
    assert tsim.max_cosine_per_voxel.launches == n2


def test_kernel_sources_are_the_build_inputs():
    names = {p.name for p in _build.sources()}
    assert names == {"short_attention_qkv.cu", "max_cosine.cu"}
    for p in _build.sources():
        head = pathlib.Path(p).read_text()[:3000]
        assert "Replaces: bsc_nav_tpu/ops/" in head and "Bound on" in head


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,heads,hd", [(2, 261, 16, 64), (3, 37, 2, 16),
                                          (1, 130, 3, 128), (2, 65, 5, 48)])
def test_k1_matches_plain(cuda, B, S, heads, hd, dtype, atol):
    """f32: sums in another order, 2e-5 abs.  bf16: both round the f32
    result to bf16 once, so they differ by at most one bf16 ulp of an
    O(1) output: 2e-2 abs."""
    qkv = _qkv(B, S, heads, hd, seed=3).to(cuda, dtype)
    before = tfa.short_attention_qkv.launches
    got = tfa.short_attention_qkv(qkv, heads)
    assert tfa.short_attention_qkv.launches == before + 1
    want = tfa.short_attention_qkv_reference(qkv, heads)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, heads * hd)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err


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


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    qkv = torch.zeros(1, 8, 3 * 2 * 64, device=cuda)
    with pytest.raises(NotImplementedError, match="K3"):
        tfa.attention_from_qkv(qkv, heads=2, causal=True)
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
    with pytest.raises(NotImplementedError, match="int8"):
        tsim.max_cosine_per_voxel(
            torch.zeros(8, 16, dtype=torch.int8, device=cuda),
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
    cpu_model = tv.init_params(vcfg, torch.Generator().manual_seed(0))
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
