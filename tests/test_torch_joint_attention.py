"""Kernel K4 ``joint_qkv_attention`` (its plain version on the CPU, its
qk-norm pre-pass's plain version, and the arithmetic order of its two
device kernels: the pre-pass, then the bf16 TMA tile or the f32 three-pass
TF32 tile on the joint fused rows) and the MMDiT attention dispatch
against the JAX package.

The JAX kernel runs in Pallas interpret mode, as the JAX package's own
tests run it on the CPU.  Gammas are drawn per stream and per q/k, so a
stream or a q/k swap shows.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.ops import flash_attention as jfa
from bsc_nav_tpu_torch.ops import flash_attention as tfa

from torch_parity import bf16_ulp, tensor_core_tile, tf32x3_tile

HEADS, HD = 4, 64


def _inputs(B, Sx, Sc, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    D = HEADS * HD
    x = rng.normal(size=(B, Sx, 3 * D)).astype(np.float32)
    c = rng.normal(size=(B, Sc, 3 * D)).astype(np.float32)
    gammas = [rng.uniform(0.2, 2.0, size=HD).astype(np.float32)
              for _ in range(4)]          # q_x, k_x, q_c, k_c
    if dtype == "bfloat16":
        x, c = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in (x, c))
    return x, c, gammas


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sx,Sc", [(2, 40, 23), (1, 70, 0), (2, 9, 130)],
                         ids=["joint", "self", "ctx-longer"])
def test_plain_version_matches_jax_kernel(B, Sx, Sc, dtype):
    """f32: both compute in f32, sums in another order: 2e-5 abs.  bf16:
    both widen the same bf16 inputs, compute in f32 and round once, so
    they differ by 2e-5 plus one bf16 ulp at the output's magnitude."""
    x, c, g = _inputs(B, Sx, Sc, seed=Sx + Sc, dtype=dtype)
    want = np.asarray(jfa.joint_qkv_attention(
        _jax(x, dtype), _jax(c, dtype), HEADS, *map(jnp.asarray, g),
        interpret=True).astype(jnp.float32))
    got = tfa.joint_qkv_attention(_torch(x, dtype), _torch(c, dtype), HEADS,
                                  *map(torch.from_numpy, g))
    assert got.shape == (B, Sx + Sc, HEADS * HD)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    got = got.float()
    tol = 2e-5 + (bf16_ulp(got).numpy() if dtype == "bfloat16" else 0)
    assert np.all(np.abs(got.numpy() - want) <= tol), \
        np.abs(got.numpy() - want).max()


def test_streams_are_not_interchangeable():
    """Swapping the two streams' gammas moves the output: the test above
    would see a kernel that read the wrong stream's gamma."""
    x, c, g = _inputs(1, 12, 7, seed=1)
    t = [torch.from_numpy(a) for a in (x, c, *g)]
    a = tfa.joint_qkv_attention(t[0], t[1], HEADS, *t[2:])
    b = tfa.joint_qkv_attention(t[0], t[1], HEADS, t[4], t[5], t[2], t[3])
    assert (a - b).abs().max() > 1e-2


@pytest.mark.parametrize("order", ["x-first", "ctx-first"])
def test_dispatch_matches_jax_composed_path(order):
    """The port's dispatch (K4's route: x rows first) against the JAX
    package's CPU route: ``joint_qkv_reference`` (x first) and the MMDiT's
    composed path, which concatenates ctx rows first
    (``mmdit.py:236-242``) -- its rows are reordered before comparing.
    f32, 2e-5 abs."""
    B, Sx, Sc = 2, 33, 17
    x, c, g = _inputs(B, Sx, Sc, seed=5)
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    jg = [jnp.asarray(a) for a in g]
    if order == "x-first":
        want = np.asarray(jfa.joint_qkv_reference(jx, jc, HEADS, *jg))
    else:
        def split(qkv, S):
            r = qkv.reshape(B, S, 3, HEADS, HD)
            return [r[:, :, i].transpose(0, 2, 1, 3) for i in range(3)]

        def rms(t, gamma):
            var = jnp.mean(jnp.square(t), axis=-1, keepdims=True)
            return t * jax.lax.rsqrt(var + 1e-6) * gamma

        qx, kx, vx = split(jx, Sx)
        qc, kc, vc = split(jc, Sc)
        att = jfa.attention(
            jnp.concatenate([rms(qc, jg[2]), rms(qx, jg[0])], axis=2),
            jnp.concatenate([rms(kc, jg[3]), rms(kx, jg[1])], axis=2),
            jnp.concatenate([vc, vx], axis=2))
        att = np.asarray(att.transpose(0, 2, 1, 3).reshape(B, Sc + Sx, -1))
        want = np.concatenate([att[:, Sc:], att[:, :Sc]], axis=1)
    got = tfa.joint_qkv_dispatch(torch.from_numpy(x), torch.from_numpy(c),
                                 HEADS, *map(torch.from_numpy, g)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_composed_reference_matches_jax(dtype):
    """``joint_qkv_reference`` (the route for qk-norm off or a refused
    shape) rounds the normalised q/k to the input dtype, as JAX does.
    f32: 2e-5 abs.  bf16: both also round the softmax probabilities to
    bf16 before P @ V, and a probability within f32 noise of a rounding
    boundary takes the neighbouring value on one side (3 of 7,936 outputs
    here, by up to 3 output ulps): 2e-5 plus four bf16 ulps."""
    x, c, g = _inputs(1, 20, 11, seed=7, dtype=dtype)
    want = np.asarray(jfa.joint_qkv_reference(
        _jax(x, dtype), _jax(c, dtype), HEADS, *map(jnp.asarray, g)
    ).astype(jnp.float32))
    got = tfa.joint_qkv_reference(_torch(x, dtype), _torch(c, dtype), HEADS,
                                  *map(torch.from_numpy, g)).float()
    tol = 2e-5 + (4 * bf16_ulp(got).numpy() if dtype == "bfloat16" else 0)
    assert np.all(np.abs(got.numpy() - want) <= tol)


def test_self_dispatch_without_qk_norm_matches_jax():
    """Gammas None: the composed path, plain attention over one stream."""
    x, _, _ = _inputs(2, 24, 0, seed=9)
    want = np.asarray(jfa.self_qkv_dispatch(jnp.asarray(x), HEADS, None,
                                            None))
    got = tfa.self_qkv_dispatch(torch.from_numpy(x), HEADS, None, None)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("S,heads,hd,qk_norm,want", [
    (1613, 24, 64, True, True), (1178, 24, 64, True, True),
    (1024, 24, 64, True, True), (4096, 2, 64, True, True),
    (4097, 2, 64, True, False), (1613, 24, 64, False, False),
    (1613, 3, 64, True, False), (1613, 4, 16, True, False)])
def test_gate_is_the_jax_rule_without_the_tpu_test(S, heads, hd, qk_norm,
                                                   want):
    """``flash_attention.py:591-595`` minus ``default_backend() == "tpu"``:
    qk-norm, head_dim 64, even heads, S <= _MID_MAX_KV."""
    assert jfa._MID_MAX_KV == tfa._MID_MAX_KV == 4096
    assert tfa.use_joint_qkv_attention(S, heads, hd, qk_norm) is want



def _k4_rows(x, c, g, dtype):
    """K4's pre-pass (csrc/joint_qkv_attention.cu) by its plain version:
    the joint fused rows in ``dtype`` (bf16: q-hat and k-hat computed in
    f32 and rounded once), split into q, k, v [B, H, S, hd]."""
    rows = tfa.joint_qk_norm_reference(_torch(x, dtype), _torch(c, dtype),
                                       HEADS, *map(torch.from_numpy, g))
    return tfa._split_heads(rows, HEADS)


def _k4_tile(x, c, g, drop_tile=None):
    """K4's bf16 order: the pre-pass, then the TMA tile
    (csrc/attention_tma.cuh) on its rows -- 128-key tiles, scores scaled
    after the dot, P rounded to bf16 -- back to [B, Sx+Sc, D]."""
    out = tensor_core_tile(*_k4_rows(x, c, g, "bfloat16"), keys=128,
                           drop_tile=drop_tile)
    return out.transpose(1, 2).reshape(x.shape[0], -1, HEADS * HD)


def _k4_tf32(x, c, g, **kw):
    """K4's f32 order: the pre-pass in f32, then the three-pass TF32 tile
    (csrc/attention_tf32.cuh, FusedQKV) on its rows, [B, Sx+Sc, D]."""
    out = tf32x3_tile(*_k4_rows(x, c, g, "float32"), **kw)
    return out.transpose(1, 2).reshape(x.shape[0], -1, HEADS * HD)


# a ragged sequence (4 key tiles, the second q tile spans both streams);
# Sx < 128, so the first q tile does; Sc = 0 (the self-attention); an odd
# batch
K4_CASES = [(1, 150, 77), (1, 100, 77), (2, 200, 0), (3, 40, 23)]


def _rounding_divergence(tx, tc_, tg):
    """Bound on |``joint_qkv_attention_bf16_reference`` -
    ``joint_qkv_attention_reference``| in f32: the deliberate divergence of
    rounding q-hat and k-hat to bf16, which the Pallas K4 does not.  Each
    is moved by at most u = 2^-8 of itself, so the logit s_ij by at most
    d_ij = scale (2u + u^2) sum_d |q_id| |k_jd| <= d_i = scale (2u + u^2)
    sum_d |q_id| max_j |k_jd|, each p_ij by a factor within e^(+-2 d_i),
    and the output by at most (e^(2 d_i) - 1) sum_j p_ij |v_j|."""
    q, k, v = tfa.joint_normalised_qkv(tx, tc_, HEADS, *tg)
    u = 2.0 ** -8
    d = (2 * u + u * u) / HD ** 0.5 * (
        q.abs() * k.abs().amax(dim=2, keepdim=True)).sum(-1, keepdim=True)
    out = torch.expm1(2 * d) * tfa.flash_attention_reference(q, k, v.abs())
    return out.transpose(1, 2).reshape(tx.shape[0], -1, HEADS * HD)


K4_IDS = ["ragged", "q-tile-spans-streams", "self", "odd-batch"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sx,Sc", K4_CASES, ids=K4_IDS)
def test_qk_norm_reference_is_the_normalised_rows(B, Sx, Sc, dtype):
    """``joint_qk_norm_reference`` (the pre-pass's plain version) lays out
    ``joint_normalised_qkv`` as joint fused rows, x rows first: q-hat and
    k-hat within 2^-17 of their value (the sums of squares in another
    order) before the one rounding to the input dtype -- in bf16 equal but
    where that value lies near a rounding midpoint, and there within one
    bf16 ulp -- and v copied exactly."""
    x, c, g = _inputs(B, Sx, Sc, seed=50 + Sx, dtype=dtype)
    tx, tc_ = _torch(x, dtype), _torch(c, dtype)
    tg = [torch.from_numpy(a) for a in g]
    rows = tfa.joint_qk_norm_reference(tx, tc_, HEADS, *tg)
    assert rows.dtype == tx.dtype and rows.shape == (B, Sx + Sc, 3 * HEADS
                                                     * HD)
    got = tfa._split_heads(rows.float(), HEADS)
    want = tfa.joint_normalised_qkv(tx, tc_, HEADS, *tg)
    assert torch.equal(got[2], want[2])
    for a, w in zip(got[:2], want[:2]):
        tol = 2.0 ** -17 * w.abs()
        if dtype == "bfloat16":
            tol = torch.where(w.to(torch.bfloat16).float() == a,
                              torch.zeros_like(w), bf16_ulp(w))
            w = w.to(torch.bfloat16).float()
        assert bool(((a - w).abs() <= tol).all()), (a - w).abs().max()
    # each stream took its own gammas: x's rows differ under ctx's
    swapped = tfa.joint_qk_norm_reference(tx, tc_, HEADS, tg[2], tg[3],
                                          tg[0], tg[1])
    assert not torch.equal(swapped[:, :Sx], rows[:, :Sx])


@pytest.mark.parametrize("B,Sx,Sc", K4_CASES, ids=K4_IDS)
def test_tf32x3_order_holds_k4_bound(B, Sx, Sc):
    """K4's f32 order (the pre-pass in f32, then the three-pass TF32 tile
    on its rows) within the f32 bound, 2e-5 abs, of the JAX package's
    Pallas K4 in interpret mode and of the port's plain version."""
    x, c, g = _inputs(B, Sx, Sc, seed=60 + Sx)
    got = _k4_tf32(x, c, g)
    pallas = torch.from_numpy(np.array(jfa.joint_qkv_attention(
        jnp.asarray(x), jnp.asarray(c), HEADS, *map(jnp.asarray, g),
        interpret=True)))
    port = tfa.joint_qkv_attention_reference(
        torch.from_numpy(x), torch.from_numpy(c), HEADS,
        *map(torch.from_numpy, g))
    for want in (pallas, port):
        diff = (got - want).abs()
        assert diff.max().item() <= 2e-5, diff.max().item()
        assert diff.max().item() > 0       # not the plain version itself


@pytest.mark.parametrize("fault", ["one-tf32-pass", "lost-key-tile",
                                   "swapped-gammas"])
def test_k4_f32_bound_catches_a_fault(fault):
    """The 2e-5 bound fails K4's f32 order with one TF32 product per f32
    product, one 64-key tile (keys 64-127) left out, or the two streams'
    gammas exchanged, against the Pallas K4."""
    B, Sx, Sc = K4_CASES[0]
    x, c, g = _inputs(B, Sx, Sc, seed=61)
    want = torch.from_numpy(np.array(jfa.joint_qkv_attention(
        jnp.asarray(x), jnp.asarray(c), HEADS, *map(jnp.asarray, g),
        interpret=True)))
    assert (_k4_tf32(x, c, g) - want).abs().max().item() <= 2e-5
    bad = (_k4_tf32(x, c, g, passes=1) if fault == "one-tf32-pass"
           else _k4_tf32(x, c, g, drop_tile=1) if fault == "lost-key-tile"
           else _k4_tf32(x, c, [g[2], g[3], g[0], g[1]]))
    assert (bad - want).abs().max().item() > 2e-5


@pytest.mark.parametrize("B,Sx,Sc", K4_CASES, ids=K4_IDS)
def test_bf16_tolerance_holds_the_tile_for_k4(B, Sx, Sc):
    """``joint_qkv_attention_bf16_tolerance`` holds the tile's order, and
    the JAX package's composed ``joint_qkv_reference`` in bf16, which
    rounds q-hat, k-hat and P as the tile does, against
    ``joint_qkv_attention_bf16_reference``.  Against the port's plain
    version and the JAX package's Pallas kernel in interpret mode, which
    keep q-hat, k-hat and P in f32 and round their output to bf16, the
    tile also takes ``_rounding_divergence`` and those outputs' ulp."""
    x, c, g = _inputs(B, Sx, Sc, seed=30 + Sx, dtype="bfloat16")
    got = _k4_tile(x, c, g)
    tx, tc_ = _torch(x, "bfloat16"), _torch(c, "bfloat16")
    tg = [torch.from_numpy(a) for a in g]
    jx, jc = _jax(x, "bfloat16"), _jax(c, "bfloat16")
    jg = [jnp.asarray(a) for a in g]
    want = tfa.joint_qkv_attention_bf16_reference(tx, tc_, HEADS, *tg)
    tol = tfa.joint_qkv_attention_bf16_tolerance(tx, tc_, HEADS, *tg, want)
    port = tfa.joint_qkv_attention_reference(tx, tc_, HEADS, *tg).float()
    pallas, composed = (
        torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))) for a in (
            jfa.joint_qkv_attention(jx, jc, HEADS, *jg, interpret=True),
            jfa.joint_qkv_reference(jx, jc, HEADS, *jg)))
    for out in (got, composed):
        diff = (out - want).abs()
        assert bool((diff <= tol).all()), (diff - tol).max().item()
    div = _rounding_divergence(tx, tc_, tg)
    for f32_order in (port, pallas):
        diff = (got - f32_order).abs()
        wide = tol + div + 2e-5 + bf16_ulp(f32_order)
        assert bool((diff <= wide).all()), (diff - wide).max().item()
    # rounding q-hat, k-hat and P is seen: the tile is not the plain version
    assert (got - port).abs().max().item() > 0


@pytest.mark.parametrize("fault", ["lost-key-tile", "swapped-gammas"])
@pytest.mark.parametrize("B,Sx,Sc", [K4_CASES[0], (1, 1024, 589)],
                         ids=["S227", "S1613"])
def test_k4_bf16_tolerance_catches_a_fault(B, Sx, Sc, fault):
    """The bound is tight enough that the same order fails it with one
    128-key tile (keys 128-255) left out, or with the two streams' gammas
    exchanged, at a short sequence and at the 512^2 query's joint length
    (13 key tiles)."""
    x, c, g = _inputs(B, Sx, Sc, seed=31, dtype="bfloat16")
    tx, tc_ = _torch(x, "bfloat16"), _torch(c, "bfloat16")
    tg = [torch.from_numpy(a) for a in g]
    want = tfa.joint_qkv_attention_bf16_reference(tx, tc_, HEADS, *tg)
    tol = tfa.joint_qkv_attention_bf16_tolerance(tx, tc_, HEADS, *tg, want)
    assert bool(((_k4_tile(x, c, g) - want).abs() <= tol).all())
    bad = (_k4_tile(x, c, g, drop_tile=1) if fault == "lost-key-tile"
           else _k4_tile(x, c, [g[2], g[3], g[0], g[1]]))
    assert not bool(((bad - want).abs() <= tol).all())
