"""Port parity: K6 ``flash_attention``'s plain version, the bf16 bound of
the tensor-core tile that K1, K3, K5 and K6 share (K4's, with its
qk-norm, is in tests/test_torch_joint_attention.py), and the port's
``attention()`` route against bsc_nav_tpu/ops/flash_attention.py.

The JAX kernels run in Pallas interpret mode, as tests/test_flash_attention.py
runs them on the CPU.  The route table holds the port's ``attention`` against
the JAX package's on a TPU (its backend test patched), at every boundary
of the rule.  The card side is in tests/test_torch_kernels.py.
"""

from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import flash_attention as jfa
from bsc_nav_tpu_torch.ops import flash_attention as tfa

from torch_parity import tensor_core_tile


def _bhsd(B, H, S, hd, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, H, S, hd)).astype(np.float32)


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", [
    (1, 2, 300, 700, 64, False),    # ragged, Sq != Sk, past one 128 block
    (2, 1, 300, 300, 64, True),     # causal, square, ragged last block
    (1, 1, 130, 4101, 16, False)])  # past K5's 4096 keys
def test_flash_attention_plain_matches_pallas_interpret(B, H, Sq, Sk, hd,
                                                        causal, dtype):
    """f32: the online softmax over 128-key blocks against one softmax,
    sums in another order: 1e-5 abs on O(1) outputs.  bf16 (the same bf16
    inputs on both sides): 1e-5 plus one bf16 ulp at the output's
    magnitude."""
    q, k, v = _bhsd(B, H, Sq, hd, 1), _bhsd(B, H, Sk, hd, 2), \
        _bhsd(B, H, Sk, hd, 3)
    jd = getattr(jnp, dtype)
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal,
        interpret=True).astype(jnp.float32))
    td = getattr(torch, dtype)
    got = tfa.flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                              causal=causal)
    assert got.dtype == td and got.shape == (B, H, Sq, hd)
    got = got.float().numpy()
    tol = 1e-5 + (_bf16_ulp(want) if dtype == "bfloat16" else 0.0)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


# ragged Sq and Sk, causal, past one 64-key tile and past 4096 keys
EMULATION_CASES = [(1, 2, 300, 700, 64, False), (2, 1, 300, 300, 64, True),
                   (1, 1, 130, 4101, 16, False), (1, 2, 77, 200, 16, False),
                   (1, 2, 150, 150, 16, True)]


def _with_keys(cases, takes_128=lambda c: c[4] == 64):
    """Each case at the 64-key tile (attention_mma.cuh), then the cases
    that K5 or K6 would run on the 128-key tile (attention_tma.cuh: bf16
    at head_dim 64) again at 128 keys, with a ``keys`` parameter; the
    64-key cases keep their plain ids."""
    ids = ["-".join(map(str, c)) for c in cases]
    return ([pytest.param(*c, 64, id=i) for c, i in zip(cases, ids)]
            + [pytest.param(*c, 128, id=i + "-keys128")
               for c, i in zip(cases, ids) if takes_128(c)])


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,keys",
                         _with_keys(EMULATION_CASES))
def test_bf16_tolerance_holds_the_tensor_core_order(B, H, Sq, Sk, hd, causal,
                                                    keys):
    """``flash_attention_bf16_tolerance`` (2e-5 + one bf16 ulp + 2^-8 x
    the plain version on |v|) holds the tensor-core K6's arithmetic, P
    rounded to bf16, at either tile's key width, against both the port's
    plain version and the JAX package's Pallas kernel in interpret mode,
    on the same bf16 inputs."""
    q, k, v = _bhsd(B, H, Sq, hd, 6), _bhsd(B, H, Sk, hd, 7), \
        _bhsd(B, H, Sk, hd, 8)
    got = tensor_core_tile(q, k, v, causal, keys=keys)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    port = tfa.flash_attention_reference(tq, tk, tv, causal).float()
    pallas = torch.from_numpy(np.array(jfa.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
        interpret=True).astype(jnp.float32)))
    for want in (port, pallas):
        tol = tfa.flash_attention_bf16_tolerance(tq, tk, tv, want, causal)
        diff = (got - want).abs()
        assert bool((diff <= tol).all()), (diff - tol).max().item()
        # rounding P is seen: the emulation is not the plain version
        assert diff.max().item() > 0


# K3 and K5 on the same tile, at their main paths' shapes, small in B*H:
# MetaCLIP's vision tower (hd 80, S 257), the causal text towers (hd 64,
# S 77), K3's ragged case and a ragged K5 case
K3_K5_CASES = [("short", 1, 2, 257, 257, 80, False),
               ("short", 1, 2, 77, 77, 64, True),
               ("short", 1, 2, 50, 203, 80, False),
               ("mid", 1, 2, 700, 1030, 64, False)]


# K5 at head_dim 64 also at the 128-key tile (K3 never takes it)
@pytest.mark.parametrize(
    "name,B,H,Sq,Sk,hd,causal,keys",
    _with_keys(K3_K5_CASES, lambda c: c[0] == "mid" and c[5] == 64))
def test_bf16_tolerance_holds_the_tile_for_k3_and_k5(name, B, H, Sq, Sk, hd,
                                                     causal, keys):
    """K3 and K5 in bf16 run K6's tiles, so ``flash_attention_bf16_tolerance``
    holds their arithmetic against the port's plain ``short_attention`` /
    ``mid_attention`` and against the JAX package's Pallas kernels in
    interpret mode, which keep P in f32: the rounding of P to bf16 is a
    deliberate divergence, bounded by the same function."""
    q, k, v = _bhsd(B, H, Sq, hd, 9), _bhsd(B, H, Sk, hd, 10), \
        _bhsd(B, H, Sk, hd, 11)
    got = tensor_core_tile(q, k, v, causal, keys=keys)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    if name == "short":
        port = tfa.short_attention_reference(tq, tk, tv, causal)
        pallas = jfa.short_attention(jq, jk, jv, causal=causal, interpret=True)
    else:
        port = tfa.mid_attention_reference(tq, tk, tv)
        pallas = jfa.mid_attention(jq, jk, jv, interpret=True)
    pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32)))
    for want in (port.float(), pallas):
        tol = tfa.flash_attention_bf16_tolerance(tq, tk, tv, want, causal)
        diff = (got - want).abs()
        assert bool((diff <= tol).all()), (diff - tol).max().item()
        assert diff.max().item() > 0


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,keys", _with_keys([
    EMULATION_CASES[0], EMULATION_CASES[1],
    K3_K5_CASES[0][1:]]))               # K3's vision shape, 5 key tiles
def test_bf16_tolerance_catches_a_lost_key_tile(B, H, Sq, Sk, hd, causal,
                                                keys):
    """The bound stays tight enough that the same arithmetic with its
    second key tile (keys 64-127, or 128-255 at the 128-key tile) left
    out fails it."""
    q, k, v = _bhsd(B, H, Sq, hd, 6), _bhsd(B, H, Sk, hd, 7), \
        _bhsd(B, H, Sk, hd, 8)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = tfa.flash_attention_reference(tq, tk, tv, causal).float()
    tol = tfa.flash_attention_bf16_tolerance(tq, tk, tv, want, causal)
    assert bool(((tensor_core_tile(q, k, v, causal, keys=keys) - want).abs()
                 <= tol).all())
    lost = tensor_core_tile(q, k, v, causal, drop_tile=1, keys=keys)
    assert not bool(((lost - want).abs() <= tol).all())


# K1 on the tile, small in B*H: ViT-L's S 261 at hd 64 (5 key tiles, a
# ragged last q tile), an odd batch at S 77, and hd 32 on the unswizzled
# layout
K1_CASES = [(1, 261, 2, 64), (3, 77, 2, 64), (2, 130, 4, 32)]


def _k1_tile(qkv, heads, drop_tile=None):
    """K1's bf16 order: the tile on the heads of the fused rows [B, S, 3D],
    back to [B, S, D]."""
    B, S, threeD = qkv.shape
    q, k, v = tfa._split_heads(torch.from_numpy(qkv), heads)
    out = tensor_core_tile(q, k, v, drop_tile=drop_tile)
    return out.transpose(1, 2).reshape(B, S, threeD // 3)


@pytest.mark.parametrize("B,S,heads,hd", K1_CASES)
def test_bf16_tolerance_holds_the_tile_for_k1(B, S, heads, hd):
    """K1 in bf16 runs the same tile on q, k and v read in place from the
    fused rows, so ``short_attention_qkv_bf16_tolerance`` (the bound above
    on the split heads) holds its order against the port's plain
    ``short_attention_qkv`` and the JAX package's Pallas kernel in
    interpret mode, which keeps P in f32: a deliberate divergence."""
    qkv = np.random.default_rng(12).normal(
        size=(B, S, 3 * heads * hd)).astype(np.float32)
    tqkv = torch.from_numpy(qkv).to(torch.bfloat16)
    got = _k1_tile(qkv, heads)
    port = tfa.short_attention_qkv_reference(tqkv, heads).float()
    pallas = torch.from_numpy(np.array(jfa.short_attention_qkv(
        jnp.asarray(qkv, jnp.bfloat16), heads, interpret=True
    ).astype(jnp.float32)))
    for want in (port, pallas):
        tol = tfa.short_attention_qkv_bf16_tolerance(tqkv, heads, want)
        diff = (got - want).abs()
        assert bool((diff <= tol).all()), (diff - tol).max().item()
        assert diff.max().item() > 0


def test_k1_bf16_tolerance_catches_a_lost_key_tile():
    """K1's bound fails the same order with keys 64-127 left out."""
    B, S, heads, hd = K1_CASES[0]
    qkv = np.random.default_rng(12).normal(
        size=(B, S, 3 * heads * hd)).astype(np.float32)
    tqkv = torch.from_numpy(qkv).to(torch.bfloat16)
    want = tfa.short_attention_qkv_reference(tqkv, heads).float()
    tol = tfa.short_attention_qkv_bf16_tolerance(tqkv, heads, want)
    assert bool(((_k1_tile(qkv, heads) - want).abs() <= tol).all())
    lost = _k1_tile(qkv, heads, drop_tile=1)
    assert not bool(((lost - want).abs() <= tol).all())


def test_causal_needs_square_attention_in_both_packages():
    q, k = _bhsd(1, 1, 16, 16, 4), _bhsd(1, 1, 24, 16, 5)
    with pytest.raises(AssertionError, match="Sq == Sk"):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                            causal=True, interpret=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.flash_attention(*map(torch.from_numpy, (q, k, k)), causal=True)


# (B, H, Sq, Sk, causal) at each edge of the rule: 640 / 641 keys,
# 4096 / 4097 keys, f32 logits of exactly 4e9 bytes and one row more
ROUTE_CASES = [
    (2, 16, 640, 640, False), (2, 16, 641, 641, False),
    (2, 16, 640, 640, True), (2, 16, 641, 641, True),
    (6, 24, 1613, 1613, False),             # SD3-medium joint, 512^2
    (1, 1, 5, 4096, False), (1, 1, 5, 4097, False),
    (6, 24, 4096, 4096, False), (6, 24, 4685, 4685, False),
    (8, 25, 1000, 5000, False), (8, 25, 1001, 5000, False),
    (1, 59, 4096, 4096, True), (1, 60, 4096, 4096, True),
    (1, 60, 4097, 4097, True), (2, 2, 4101, 4101, False),
]


@pytest.mark.parametrize("B,H,Sq,Sk,causal", ROUTE_CASES)
def test_attention_route_matches_jax_rule(monkeypatch, B, H, Sq, Sk, causal):
    """The port's ``attention`` calls the counterpart of the function the
    JAX package's would call on a TPU: short / mid / flash, or the plain
    ``reference_attention`` (the JAX package's composition outside any
    kernel).  Only shapes are read, so the arguments are shape holders."""
    called = []

    def record(name):
        return lambda *a, **kw: called.append(name)

    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    for name in ("short", "mid", "flash", "reference"):
        fn = f"{name}_attention"
        monkeypatch.setattr(jfa, fn, record("jax-" + name))
        monkeypatch.setattr(tfa, fn, record("port-" + name))
    q = SimpleNamespace(shape=(B, H, Sq, 64))
    k = SimpleNamespace(shape=(B, H, Sk, 64))
    jfa.attention(q, k, k, causal=causal)
    tfa.attention(q, k, k, causal=causal)
    route = tfa.attention_route(B, H, Sq, Sk, causal)
    assert called == ["jax-" + route, "port-" + route]
