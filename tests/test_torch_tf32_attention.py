"""Port parity: the f32 attention tile of K1 ``short_attention_qkv``, K3
``short_attention``, K5 ``mid_attention`` and K6 ``flash_attention``
(bsc_nav_tpu_torch/csrc/attention_tf32.cuh), whose every product of f32
operands is three TF32 products on the tensor cores, emulated in plain
torch (``tests/torch_parity.py`` ``tf32x3_tile``) and held to the f32 bound
the card holds the kernels to: 2e-5 abs against the port's plain versions
and the JAX package's Pallas kernels in interpret mode, as
tests/test_flash_attention.py runs them on the CPU.  The same bound must
catch one TF32 pass and a lost key tile, at K1's and K3's lengths and
across the many key tiles of K5's and K6's.  The card side is in
tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import flash_attention as jfa
from bsc_nav_tpu_torch.ops import flash_attention as tfa

from torch_parity import tf32_rna, tf32_split, tf32x3_tile

F32_TOL = 2e-5      # abs: chip_smoke.py K1_TOL / K3_TOL, the card tests' f32


def _bhsd(B, H, S, hd, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, H, S, hd)).astype(np.float32)


def test_tf32_split_rounds_to_nearest_away():
    """hi is the TF32 value nearest x (ties away from zero), lo the TF32
    value nearest x - hi, so hi + lo is within 2^-22 |x| of x."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096),
        [0.0, 1.0, -1.0, 1 + 2 ** -11, -(1 + 3 * 2 ** -11)]]).astype(
            np.float32))
    hi, lo = tf32_split(x)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    xd, hd = x.double(), hi.double()
    ulp = torch.exp2(torch.floor(torch.log2(xd.abs().clamp(min=1e-30))) - 10)
    assert bool(((xd - hd).abs() <= ulp / 2).all())
    ties = torch.tensor([1 + 2 ** -11, -(1 + 3 * 2 ** -11)])
    assert tf32_rna(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -9)]
    assert bool(((xd - hd - lo.double()).abs()
                 <= 2.0 ** -22 * xd.abs()).all())


# K3 at small B*H: MetaCLIP's vision tower (hd 80, S 257), the causal text
# towers (hd 64, S 77), K3's ragged case, hd 16 causal and ragged
K3_CASES = [(1, 2, 257, 257, 80, False), (1, 2, 77, 77, 64, True),
            (1, 3, 50, 203, 80, False), (2, 2, 100, 100, 16, True),
            (1, 2, 65, 130, 16, False)]


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", K3_CASES)
def test_tf32x3_order_holds_k3_bound(B, H, Sq, Sk, hd, causal):
    """The three-pass order within 2e-5 abs of the port's plain
    ``short_attention_reference`` and the Pallas ``short_attention``."""
    q, k, v = _bhsd(B, H, Sq, hd, 1), _bhsd(B, H, Sk, hd, 2), \
        _bhsd(B, H, Sk, hd, 3)
    got = tf32x3_tile(q, k, v, causal)
    port = tfa.short_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    pallas = torch.from_numpy(np.array(jfa.short_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)))
    for want in (port, pallas):
        diff = (got - want).abs()
        assert diff.max().item() <= F32_TOL, diff.max().item()
        assert diff.max().item() > 0       # not the plain version itself


# K1 at small B: ViT-L's S 261 at hd 64, an odd batch at S 77, hd 16
# (the Pallas K1 takes hd <= 64 and an even head count)
K1_CASES = [(1, 261, 2, 64), (3, 77, 2, 64), (2, 130, 4, 16)]


@pytest.mark.parametrize("B,S,heads,hd", K1_CASES)
def test_tf32x3_order_holds_k1_bound(B, S, heads, hd):
    """K1 runs the same tile on q, k and v read in place from the fused
    rows: the order on the split heads, back to [B, S, D], within 2e-5 abs
    of ``short_attention_qkv_reference`` and the Pallas
    ``short_attention_qkv``."""
    qkv = np.random.default_rng(4).normal(
        size=(B, S, 3 * heads * hd)).astype(np.float32)
    q, k, v = tfa._split_heads(torch.from_numpy(qkv), heads)
    got = tf32x3_tile(q, k, v).transpose(1, 2).reshape(B, S, heads * hd)
    port = tfa.short_attention_qkv_reference(torch.from_numpy(qkv), heads)
    pallas = torch.from_numpy(np.array(jfa.short_attention_qkv(
        jnp.asarray(qkv), heads, interpret=True)))
    for want in (port, pallas):
        diff = (got - want).abs()
        assert diff.max().item() <= F32_TOL, diff.max().item()
        assert diff.max().item() > 0


# the main paths' shapes at batch 1: K1 at ViT-L (16 x 64, S 261), K3 at
# MetaCLIP ViT-H's vision tower (16 x 80, S 257)
MAIN_SHAPES = [(1, 16, 261, 261, 64, False), (1, 16, 257, 257, 80, False)]


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", MAIN_SHAPES)
def test_f32_bound_catches_one_tf32_pass(B, H, Sq, Sk, hd, causal):
    """One TF32 product per f32 product (10-bit mantissas) misses the 2e-5
    bound that three meet."""
    q, k, v = _bhsd(B, H, Sq, hd, 5), _bhsd(B, H, Sk, hd, 6), \
        _bhsd(B, H, Sk, hd, 7)
    want = tfa.short_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    three = (tf32x3_tile(q, k, v, causal) - want).abs().max().item()
    one = (tf32x3_tile(q, k, v, causal, passes=1) - want).abs().max().item()
    assert three <= F32_TOL < one, (three, one)


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", [MAIN_SHAPES[1],
                                                 K3_CASES[1]])
def test_f32_bound_catches_a_lost_key_tile(B, H, Sq, Sk, hd, causal):
    """The same order with one 64-key tile (keys 64-127) left out fails
    the bound."""
    q, k, v = _bhsd(B, H, Sq, hd, 8), _bhsd(B, H, Sk, hd, 9), \
        _bhsd(B, H, Sk, hd, 10)
    want = tfa.short_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    lost = tf32x3_tile(q, k, v, causal, drop_tile=1)
    assert (lost - want).abs().max().item() > F32_TOL


# K5 and K6 at small B*H across many 64-key tiles (11-40): K5 with ragged
# Sq at Sk 641 (just past K3's reach) and at SD3-medium's 1613, K6 with one
# head at a long non-causal Sk and at a causal S
K5_CASES = [(1, 2, 300, 641, 64), (1, 2, 700, 1613, 64)]
K6_CASES = [(1, 1, 130, 2500, 64, False), (1, 1, 1030, 1030, 64, True)]


@pytest.mark.parametrize("B,H,Sq,Sk,hd", K5_CASES)
def test_tf32x3_order_holds_k5_bound(B, H, Sq, Sk, hd):
    """The three-pass order within 2e-5 abs of the port's plain
    ``mid_attention_reference`` and the Pallas ``mid_attention``."""
    q, k, v = _bhsd(B, H, Sq, hd, 11), _bhsd(B, H, Sk, hd, 12), \
        _bhsd(B, H, Sk, hd, 13)
    got = tf32x3_tile(q, k, v)
    port = tfa.mid_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)))
    pallas = torch.from_numpy(np.array(jfa.mid_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True)))
    for want in (port, pallas):
        diff = (got - want).abs()
        assert diff.max().item() <= F32_TOL, diff.max().item()
        assert diff.max().item() > 0


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", K6_CASES)
def test_tf32x3_order_holds_k6_bound(B, H, Sq, Sk, hd, causal):
    """The three-pass order within 2e-5 abs of the port's plain
    ``flash_attention_reference`` and the Pallas ``flash_attention``."""
    q, k, v = _bhsd(B, H, Sq, hd, 14), _bhsd(B, H, Sk, hd, 15), \
        _bhsd(B, H, Sk, hd, 16)
    got = tf32x3_tile(q, k, v, causal)
    port = tfa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    pallas = torch.from_numpy(np.array(jfa.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)))
    for want in (port, pallas):
        diff = (got - want).abs()
        assert diff.max().item() <= F32_TOL, diff.max().item()
        assert diff.max().item() > 0


LONG_CASES = [(*K5_CASES[1], False), *K6_CASES]


@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal", LONG_CASES)
def test_f32_bound_catches_one_pass_and_a_lost_tile_on_long_keys(
        B, H, Sq, Sk, hd, causal):
    """Across K5's and K6's many key tiles, one TF32 product per f32
    product and the three-pass order with one 64-key tile (keys 64-127)
    left out each miss the 2e-5 bound that the three-pass order meets."""
    q, k, v = _bhsd(B, H, Sq, hd, 17), _bhsd(B, H, Sk, hd, 18), \
        _bhsd(B, H, Sk, hd, 19)
    want = tfa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    three = (tf32x3_tile(q, k, v, causal) - want).abs().max().item()
    one = (tf32x3_tile(q, k, v, causal, passes=1) - want).abs().max().item()
    lost = (tf32x3_tile(q, k, v, causal, drop_tile=1) - want
            ).abs().max().item()
    assert three <= F32_TOL < min(one, lost), (three, one, lost)
