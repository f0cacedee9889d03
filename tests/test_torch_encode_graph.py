"""The memory build's encode (``memory/pipeline.encode_patch_grid``): its
preprocess constants, built once a shape, and on the card the CUDA graph
it replays.

This file imports no JAX, so the card tests also run where JAX is not
installed.  On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_encode_graph.py

Without a card the ``cuda`` tests skip; the CPU tests check the constants
and that the CPU and a mesh take the eager path unchanged.
"""

import copy
import dataclasses
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bsc_nav_tpu_torch.config import QueryConfig, small_test_config
from bsc_nav_tpu_torch.memory import pipeline
from bsc_nav_tpu_torch.models import vit
from bsc_nav_tpu_torch.ops import flash_attention as fa
from bsc_nav_tpu_torch.utils.profiling import TELEMETRY, device_kernels

TINY = vit.ViTConfig(img_size=28, patch_size=14, dim=64, depth=2, heads=4,
                     num_registers=2)


def _counts():
    return {k: TELEMETRY.counters[f"encode.{k}"]
            for k in ("eager_calls", "graph_captures", "graph_replays")}


def _rise(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _frames(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=shape, dtype=np.uint8))


def _config(size):
    c = small_test_config()
    return dataclasses.replace(c, query=QueryConfig(
        top_k=c.query.top_k, query_width=size, query_height=size))


def _tiny_model(dtype=torch.float32):
    m = vit.init_params(TINY, torch.Generator().manual_seed(3), dtype=dtype,
                        device="cpu")
    with torch.no_grad():
        for blk in m.blocks:
            blk.ls1.fill_(0.3)
            blk.ls2.fill_(0.3)
    return m


def _encode_as_before(model, images, vcfg, size, dtype):
    """The encode as it was written before its constants were cached: the
    resize matrices from numpy and the ImageNet constants made a call."""
    x = images.to(torch.float32) / 255.0
    H, W = images.shape[1:3]
    wh = torch.from_numpy(vit.resize_weights(H, size, "bilinear"))
    ww = torch.from_numpy(vit.resize_weights(W, size, "bilinear"))
    x = torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)
    x = ((x - torch.tensor(vit.IMAGENET_MEAN))
         / torch.tensor(vit.IMAGENET_STD)).to(dtype)
    feats = model.forward_features(x)["x_norm_patchtokens"]
    g = size // vcfg.patch_size
    return feats.reshape(images.shape[0], g, g, -1)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst,method,dtype", [
    (680, 224, "bilinear", torch.float32),
    (64, 28, "bilinear", torch.float32),
    (37, 16, "bicubic", torch.float32),
    (680, 224, "bilinear", torch.bfloat16),
])
def test_cached_resize_matrix_is_resize_weights(src, dst, method, dtype):
    got = vit.resize_matrix(src, dst, method, dtype, torch.device("cpu"))
    want = torch.from_numpy(vit.resize_weights(src, dst, method)).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_cached_imagenet_stats_are_the_constants():
    mean, std = vit.imagenet_stats(torch.device("cpu"))
    assert torch.equal(mean, torch.tensor(vit.IMAGENET_MEAN,
                                          dtype=torch.float32))
    assert torch.equal(std, torch.tensor(vit.IMAGENET_STD,
                                         dtype=torch.float32))


def test_second_preprocess_builds_no_matrix():
    # a shape no other test resizes from, with H != W: two matrices
    img = _frames((2, 53, 61, 3), 0)
    built = vit.resize_matrix.cache_info().misses
    first = vit.preprocess(img, out_hw=(19, 23))
    assert vit.resize_matrix.cache_info().misses - built == 2
    built = vit.resize_matrix.cache_info().misses
    stats = vit.imagenet_stats.cache_info().misses
    second = vit.preprocess(img, out_hw=(19, 23))
    assert vit.resize_matrix.cache_info().misses == built
    assert vit.imagenet_stats.cache_info().misses == stats
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_encode_gives_the_tokens_it_gave_before(dtype):
    model = _tiny_model(dtype)
    img = _frames((3, 50, 50, 3), 1)
    want = _encode_as_before(model, img, TINY, 28, dtype)
    before = _counts()
    got = pipeline.encode_patch_grid(model, img, TINY, _config(28), dtype)
    assert _rise(before) == {"eager_calls": 1, "graph_captures": 0,
                             "graph_replays": 0}
    assert got.shape == (3, 2, 2, TINY.dim) and got.dtype == dtype
    assert torch.equal(got, want)
    assert len(model.graphs) == 0


def test_mesh_takes_the_eager_path():
    # a stand-in mesh of one shard: the blocks run whole, with no
    # collective, and the encode stays eager
    model = _tiny_model()
    img = _frames((2, 40, 40, 3), 2)
    cfg = _config(28)
    want = pipeline.encode_patch_grid(model, img, TINY, cfg)
    before = _counts()
    got = pipeline.encode_patch_grid(model, img, TINY, cfg,
                                     tp_mesh=SimpleNamespace(mp=1))
    assert _rise(before)["eager_calls"] == 1
    assert torch.equal(got, want) and len(model.graphs) == 0


@pytest.mark.parametrize("how", ["deepcopy", "pickle"])
def test_a_copy_of_the_model_holds_no_graph(how):
    model = _tiny_model()
    model.graphs["key"] = object()
    out = (copy.deepcopy(model) if how == "deepcopy"
           else pickle.loads(pickle.dumps(model)))
    assert isinstance(out.graphs, vit.GraphCache) and len(out.graphs) == 0
    assert torch.equal(out.norm.scale, model.norm.scale)
    assert len(model.graphs) == 1


# --------------------------------------------------------------------------
# card: ViT-L/14-reg at the memory build's batch, 8 frames of 680^2
# --------------------------------------------------------------------------

B, HW = 8, 680


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build and run only "
                    "on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _vitl(dev, kind, seed=7):
    """ViT-L/14-reg with random weights, layer scales 0.3 (a fresh init's
    1e-5 hides every block); kind: bf16, f32 or int8 (the bf16 model's
    W8A8 leaves)."""
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    m = vit.init_params(vit.DINOV2_VITL14_REG, torch.Generator(
        device=dev).manual_seed(seed), dtype=dtype, device=dev)
    with torch.no_grad():
        for blk in m.blocks:
            blk.ls1.fill_(0.3)
            blk.ls2.fill_(0.3)
    return vit.quantize_params(m) if kind == "int8" else m


def _card_frames(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (B, HW, HW, 3), generator=g, device=dev,
                         dtype=torch.uint8)


def _call(model, frames, dtype):
    return pipeline.encode_patch_grid(model, frames, model.cfg,
                                      _config(224), dtype)


def _eager(model, frames, dtype):
    return pipeline._encode(model, frames, model.cfg, _config(224), dtype)


def _dtype(kind):
    return torch.float32 if kind == "f32" else torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
def test_graph_replays_the_eager_encode(cuda, kind):
    model, dtype = _vitl(cuda, kind), _dtype(kind)
    frames = _card_frames(cuda, 11)
    want = _eager(model, frames, dtype)
    before = _counts()
    first = _call(model, frames, dtype)
    assert _rise(before) == {"eager_calls": 1, "graph_captures": 0,
                             "graph_replays": 0}
    second = _call(model, frames, dtype)
    assert _rise(before) == {"eager_calls": 1, "graph_captures": 1,
                             "graph_replays": 1}
    third = _call(model, frames, dtype)
    assert _rise(before) == {"eager_calls": 1, "graph_captures": 1,
                             "graph_replays": 2}
    torch.cuda.synchronize()
    assert third.shape == (B, 16, 16, 1024) and third.dtype == dtype
    # the same launches on the same operands: bit for bit
    for got in (first, second, third):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_replay_takes_new_frames_and_keeps_earlier_results(cuda):
    model = _vitl(cuda, "bf16")
    f1, f2 = _card_frames(cuda, 21), _card_frames(cuda, 22)
    for _ in range(2):
        _call(model, f1, torch.bfloat16)
    r1 = _call(model, f1, torch.bfloat16)
    kept = r1.clone()
    r2 = _call(model, f2, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(r1, kept)
    assert not torch.equal(r2, r1)
    assert torch.equal(r2, _eager(model, f2, torch.bfloat16))


@pytest.mark.cuda
def test_weights_changed_in_place_show_in_the_replay(cuda):
    model = _vitl(cuda, "bf16")
    frames = _card_frames(cuda, 31)
    for _ in range(2):
        _call(model, frames, torch.bfloat16)
    old = _call(model, frames, torch.bfloat16)
    with torch.no_grad():
        model.blocks[5].fc2.b.add_(0.5)
        model.norm.bias.add_(0.25)
    before = _counts()
    got = _call(model, frames, torch.bfloat16)
    assert _rise(before) == {"eager_calls": 0, "graph_captures": 0,
                             "graph_replays": 1}
    assert not torch.equal(got, old)
    assert torch.equal(got, _eager(model, frames, torch.bfloat16))


@pytest.mark.cuda
def test_replaced_parameter_storage_drops_the_graph(cuda):
    model = _vitl(cuda, "bf16")
    frames = _card_frames(cuda, 41)
    for _ in range(2):
        _call(model, frames, torch.bfloat16)
    assert len(model.graphs) == 1
    w = model.blocks[3].qkv.w
    w.data = w.data * 1.5
    before = _counts()
    got = _call(model, frames, torch.bfloat16)
    assert _rise(before) == {"eager_calls": 1, "graph_captures": 0,
                             "graph_replays": 0}
    assert torch.equal(got, _eager(model, frames, torch.bfloat16))
    again = _call(model, frames, torch.bfloat16)
    assert _rise(before) == {"eager_calls": 1, "graph_captures": 1,
                             "graph_replays": 1}
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_k1_launches_count_each_replay(cuda):
    model = _vitl(cuda, "bf16")
    frames = _card_frames(cuda, 51)
    n = model.cfg.depth
    for i in range(4):
        before = fa.short_attention_qkv.launches
        _call(model, frames, torch.bfloat16)
        # the warm-up, the capture (its replay counts; the capture itself
        # ran nothing), two replays
        assert fa.short_attention_qkv.launches - before == n, i
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_replayed_kernels_show_in_the_profiler(cuda):
    model = _vitl(cuda, "bf16")
    frames = _card_frames(cuda, 61)
    for _ in range(2):
        _call(model, frames, torch.bfloat16)
    names = device_kernels(lambda: _call(model, frames, torch.bfloat16))
    assert sum("attention_wgmma_kernel" in k for k in names) == \
        model.cfg.depth, names


@pytest.mark.cuda
def test_mesh_stays_eager_on_the_card(cuda):
    model = _vitl(cuda, "bf16")
    frames = _card_frames(cuda, 71)
    before = _counts()
    for _ in range(3):
        got = pipeline.encode_patch_grid(
            model, frames, model.cfg, _config(224), torch.bfloat16,
            tp_mesh=SimpleNamespace(mp=1))
    assert _rise(before) == {"eager_calls": 3, "graph_captures": 0,
                             "graph_replays": 0}
    assert len(model.graphs) == 0
    assert torch.equal(got, _eager(model, frames, torch.bfloat16))
