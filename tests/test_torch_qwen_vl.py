"""Port parity: the Qwen2.5-VL judge (``bsc_nav_tpu_torch/models/qwen_vl.py``)
against ``bsc_nav_tpu/models/qwen_vl.py`` at ``QWEN_VL_TEST`` sizes, and
the int8 linear's padding (``ops/quant.padded_int8_matmul``).

One seeded numpy tree (the JAX ``init_params`` layout; weights of std 0.2
so that the tiny widths give O(1) activations, random biases and norm
scales) goes to both packages.  f32 is held to 1e-5 of the output's
largest magnitude (sums in another order); bf16 to 2^-6 of it (a few bf16
roundings, 2^-9 each, that land otherwise on either side and carry through
two layers).  Greedy tokens follow the margin rule of ROADMAP Queue 3: the
sequences agree up to the first step whose top-2 logit margin on the port
is under ``MARGIN``, where the two may part.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsc_nav_tpu.models import qwen_vl as JQ
from bsc_nav_tpu_torch.models import qwen_vl as TQ
from bsc_nav_tpu_torch.models.weights import qwen_vl_from_jax_params
from bsc_nav_tpu_torch.ops import quant as tq

CFG_J, CFG_T = JQ.QWEN_VL_TEST, TQ.QWEN_VL_TEST
GRIDS = ((1, 4, 8), (1, 8, 8))          # 8 + 16 merged tokens
# the JAX side jitted: one program each instead of a compile per eager op
j_vision = jax.jit(JQ.vision_forward, static_argnums=(2, 3))
j_merge = jax.jit(JQ.merge_vision_embeds, static_argnums=(3,))
j_text = jax.jit(JQ.text_forward, static_argnums=(3,))
F32_TOL, BF16_TOL = 1e-5, 2.0 ** -6     # of the output's max |value|
MARGIN = 1e-3                           # top-2 logit margin, f32
# int8 on both sides: equal codes up to an activation scale an ulp apart
# (XLA multiplies by f32(1/127) under jit); a code flipped at .5 moves a
# logit by ~|w| / 127 of a row (tests/test_torch_clip.py's INT8_TOL logic)
INT8_TOL = 1e-2                         # of the logits' max |value|
NORMS = {"norm1", "norm2", "ln_q", "ln1", "ln2", "norm"}


def numpy_tree(seed: int = 0):
    """JAX ``init_params``'s tree with weights of std 0.2 and random biases
    and norm scales, as numpy f32."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, JQ.init_params(CFG_J, None))

    def fill(node, name=""):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        if name in NORMS:
            return (1 + 0.1 * rng.normal(size=node.shape)).astype(np.float32)
        if name.endswith("_b"):
            return (0.05 * rng.normal(size=node.shape)).astype(np.float32)
        return (0.2 * rng.normal(size=node.shape)).astype(np.float32)

    return fill(tree)


@pytest.fixture(scope="module")
def trees():
    """{dtype name: (JAX tree, port tree)} on the CPU, f32 and bf16."""
    base = numpy_tree()
    out = {}
    for name, jd, td in (("f32", jnp.float32, torch.float32),
                         ("bf16", jnp.bfloat16, torch.bfloat16)):
        jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), base)
        tt = qwen_vl_from_jax_params(base, CFG_T, dtype=td, device="cpu")
        out[name] = (jt, tt)
    return out


def _tol(name):
    return F32_TOL if name == "f32" else BF16_TOL


def _close(got: torch.Tensor, want, tol, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _patches(seed, grids=GRIDS):
    v = CFG_J.vision
    n = sum(t * h * w for t, h, w in grids)
    return np.random.default_rng(seed).normal(
        size=(n, v.in_ch * v.temporal_patch * v.patch * v.patch)
    ).astype(np.float32)


@pytest.mark.parametrize("vcfg,grids", [
    (CFG_J.vision, [(1, 4, 8)]), (CFG_J.vision, list(GRIDS)),
    (CFG_J.vision, [(2, 6, 10), (1, 4, 4)]),
    (JQ.QWEN25_VL_3B.vision, [(1, 16, 16)]),
    (JQ.QWEN25_VL_3B.vision, [(1, 16, 16)] * 3 + [(1, 20, 12)])])
def test_vision_window_layout_equal(vcfg, grids):
    """The host window bookkeeping, at the test config and at the 3B's
    (224^2 images: 4 windows of 64 merged patches each), array-equal."""
    tv = TQ.QwenVLVisionConfig(**dataclasses.asdict(vcfg))
    for a, b in zip(JQ.vision_window_layout(vcfg, grids),
                    TQ.vision_window_layout(tv, grids)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_vision_forward_matches_jax(trees, name):
    """Two images of the test grid: windowed and full attention, the 2-D
    rotary, the merger and the un-shuffle."""
    jt, tt = trees[name]
    px = _patches(1)
    want = j_vision(jt["vision"], jnp.asarray(px), GRIDS, CFG_J.vision)
    got = TQ.vision_forward(tt["vision"], torch.from_numpy(px), GRIDS,
                            CFG_T.vision)
    assert got.dtype == torch.float32      # f32 patches: f32 activations
    _close(got, want, _tol(name), "vision")


def test_mrope_cos_sin_matches_jax():
    """Positions up to 40,000 (the f32 angle's range reduction): 2e-6
    abs, a few ulps of the angle's f32 rounding at that size."""
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 40_000, size=(3, 2, 37))
    for tcfg in (CFG_J.text, JQ.QWEN25_VL_3B.text):
        t = TQ.QwenVLTextConfig(**dataclasses.asdict(tcfg))
        for a, b in zip(JQ.mrope_cos_sin(jnp.asarray(pos), tcfg),
                        TQ.mrope_cos_sin(torch.from_numpy(pos), t)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6,
                                       rtol=0)


def _mm_inputs(seed):
    """ids with two images (8 + 16 pads) between text, and their M-RoPE
    positions."""
    from bsc_nav_tpu.agents.local_vlm import mm_position_ids
    rng = np.random.default_rng(seed)
    img = CFG_J.image_token_id
    ids = np.concatenate([rng.integers(1, 100, 3), [122], np.full(8, img),
                          [123], rng.integers(1, 100, 4), [122],
                          np.full(16, img), [123], rng.integers(1, 100, 5)])
    pos = mm_position_ids(ids, img, GRIDS, CFG_J.vision.merge)
    return ids.astype(np.int64)[None], pos


def test_merge_vision_embeds_matches_jax(trees):
    jt, tt = trees["f32"]
    ids, _ = _mm_inputs(3)
    vis = np.random.default_rng(4).normal(size=(24, 24)).astype(np.float32)
    want = j_merge(jt, jnp.asarray(ids), jnp.asarray(vis),
                   CFG_J.image_token_id)
    got = TQ.merge_vision_embeds(tt, torch.from_numpy(ids),
                                 torch.from_numpy(vis), CFG_T.image_token_id)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_text_forward_matches_jax(trees, name):
    """The multimodal sequence through the decoder, with a valid length
    short of the sequence (masked keys)."""
    jt, tt = trees[name]
    ids, pos = _mm_inputs(5)
    px = _patches(6)
    jvis = j_vision(jt["vision"], jnp.asarray(px), GRIDS, CFG_J.vision)
    jemb = j_merge(jt, jnp.asarray(ids), jvis, CFG_J.image_token_id)
    valid = np.array([ids.shape[1] - 3])
    want = j_text(jt, jemb, jnp.asarray(pos), CFG_J.text,
                  jnp.asarray(valid))
    # the same embeddings on both sides: the decoder alone
    temb = torch.from_numpy(np.array(jnp.asarray(jemb, jnp.float32))).to(
        tt["embed"].dtype)
    got = TQ.text_forward(tt, temb, torch.from_numpy(pos), CFG_T.text,
                          torch.from_numpy(valid))
    assert got.dtype == tt["embed"].dtype
    _close(got, want, _tol(name), "logits")


def _first_parting(got, want, trace):
    """Index of the first differing token, or None; there the port's top-2
    margin must be under MARGIN."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            top = torch.topk(trace[i].float(), 2).values
            assert float(top[0] - top[1]) < MARGIN, (i, got, want)
            return i
    assert len(got) == len(want), (got, want)
    return None


@pytest.mark.parametrize("quantize", [False, True])
def test_greedy_generation_matches_jax(trees, quantize):
    """f32: the generator's tokens and count against JAX's
    ``make_greedy_generator`` on a padded multimodal prompt (prompt padding
    and the cache path), under the margin rule; int8 (``quantize_params``
    on both) too."""
    jt, tt = trees["f32"]
    if quantize:
        jt, tt = JQ.quantize_params(jt), TQ.quantize_params(tt)
    ids, pos = _mm_inputs(7)
    px = _patches(8)
    jvis = j_vision(jt["vision"], jnp.asarray(px), GRIDS, CFG_J.vision)
    jemb = j_merge(jt, jnp.asarray(ids), jvis, CFG_J.image_token_id)
    S, max_len, max_new, eos = ids.shape[1], ids.shape[1] + 5, 12, 127
    start = int(pos.max()) + 1
    emb_p = jnp.pad(jemb, ((0, 0), (0, max_len - S), (0, 0)))
    pos_p = np.pad(pos, ((0, 0), (0, 0), (0, max_len - S)))
    gen = JQ.make_greedy_generator(CFG_J.text, max_len, max_new, eos)
    tokens, n = gen(jt, emb_p, jnp.asarray(S, jnp.int32),
                    jnp.asarray(pos_p), jnp.asarray(start, jnp.int32))
    want = np.asarray(tokens)
    tgen = TQ.make_greedy_generator(CFG_T.text, max_len, max_new, eos)
    trace = []
    got, tn = tgen(tt, torch.from_numpy(np.asarray(emb_p)), S,
                   torch.from_numpy(pos_p), start, trace=trace)
    assert got.dtype == torch.int32 and got.shape == (max_new,)
    assert len(trace) == tn
    cut = _first_parting(got[:tn].tolist(), want[:int(n)].tolist(), trace)
    if cut is None:
        np.testing.assert_array_equal(got.numpy(), want)
        assert tn == int(n)


def test_generator_logits_equal_text_forward(trees):
    """The KV-cache path: the prefill's and each decode step's logits equal
    ``text_forward`` over the prompt and the tokens so far (f32, 1e-5 of
    max |logit|); a prompt longer than its bucket raises in the client."""
    _, tt = trees["f32"]
    ids, pos = _mm_inputs(9)
    emb = TQ.embed_tokens(tt, torch.from_numpy(ids))
    S, max_len, max_new = ids.shape[1], ids.shape[1] + 3, 6
    start = int(pos.max()) + 1
    gen = TQ.make_greedy_generator(CFG_T.text, max_len, max_new, eos_id=-1)
    trace = []
    toks, n = gen(tt, torch.nn.functional.pad(emb, (0, 0, 0, max_len - S)),
                  S, torch.from_numpy(np.pad(pos, ((0, 0), (0, 0),
                                                   (0, max_len - S)))),
                  start, trace=trace)
    assert n == max_new
    full_ids = torch.cat([torch.from_numpy(ids[0]), toks[:-1].long()])
    full_pos = np.concatenate(
        [pos, np.broadcast_to(start + np.arange(max_new - 1),
                              (3, 1, max_new - 1))], axis=-1)
    ref = TQ.text_forward(tt, TQ.embed_tokens(tt, full_ids[None]),
                          torch.from_numpy(full_pos), CFG_T.text)[0]
    for i, logits in enumerate(trace):
        want = ref[S - 1 + i]
        assert float((logits - want).abs().max()) <= (
            F32_TOL * float(want.abs().max())), i
        assert int(toks[i]) == int(torch.argmax(want))


def test_quantize_params_codes_equal(trees):
    """quantize_params on both sides, every scope: the same leaves are
    int8, with equal codes and scales (true division on both, eagerly)."""
    jt, tt = trees["f32"]
    from bsc_nav_tpu_torch.models.weights import flatten_params
    for scope in ("text", "vision", "all"):
        jq_ = jax.tree_util.tree_map(np.asarray,
                                     JQ.quantize_params(jt, scope))
        tq_ = TQ.quantize_params(tt, scope)
        a = flatten_params(jq_)
        b = {k: v.numpy() for k, v in _flat(tq_).items()}
        assert sorted(a) == sorted(b), scope
        for k in a:
            if k.endswith(("w_q", "w_s")):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("scope", ["text", "all"])
def test_int8_forward_matches_jax(trees, scope):
    """The W8A8 decoder (and under "all" the vision tower, whose MLP width
    40 is not a multiple of 8) against JAX's, within INT8_TOL of the
    logits' max |value|."""
    jt, tt = trees["f32"]
    jt, tt = JQ.quantize_params(jt, scope), TQ.quantize_params(tt, scope)
    ids, pos = _mm_inputs(10)
    px = _patches(11)
    jvis = j_vision(jt["vision"], jnp.asarray(px), GRIDS, CFG_J.vision)
    tvis = TQ.vision_forward(tt["vision"], torch.from_numpy(px), GRIDS,
                             CFG_T.vision)
    _close(tvis, jvis, INT8_TOL, "vision")
    jemb = j_merge(jt, jnp.asarray(ids), jvis, CFG_J.image_token_id)
    want = j_text(jt, jemb, jnp.asarray(pos), CFG_J.text)
    got = TQ.text_forward(tt, torch.from_numpy(np.asarray(jemb)),
                          torch.from_numpy(pos), CFG_T.text)
    _close(got, want, INT8_TOL, "logits")


def _exact(a, b):
    return (a.double() @ b.double()).to(torch.int32)


@pytest.mark.parametrize("K,N", [(64, 48), (40, 24), (37, 19), (2048, 11),
                                 (24, 300), (133, 40)])
def test_int8_padding_is_exact(K, N):
    """padded_int8_matmul pads to what torch._int_mm takes on the card
    (more than 16 rows; K a multiple of 8 and at least 128, N a multiple
    of 8) and slices: against the exact product for M 1-17 and widths not
    a multiple of 8.  The product here is the exact one on the padded
    operands, checked to see them padded."""
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    for M in range(1, 18):
        x = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
        seen = []

        def mm(a, b):
            seen.append((a.shape, b.shape, a.is_contiguous(),
                         b.is_contiguous()))
            return _exact(a, b)

        got = tq.padded_int8_matmul(x, w, mm=mm)
        Mp, Kp, Np = tq.int8_gemm_shape(M, K, N)
        assert Mp > 16 and Kp % 8 == 0 and Kp >= 128 and Np % 8 == 0
        assert seen == [((Mp, Kp), (Kp, Np), True, True)]
        assert got.dtype == torch.int32 and got.shape == (M, N)
        assert torch.equal(got, _exact(x, w)), M
    assert tq.int8_gemm_shape(17, 2048, 48) == (17, 2048, 48)
    assert tq.int8_gemm_shape(1, 3420, 1280) == (24, 3424, 1280)
    assert tq.int8_gemm_shape(40, 24, 300) == (40, 128, 304)


@pytest.mark.parametrize("M", [1, 3, 16])
def test_linear_q8_decode_rows_match_jax(M):
    """linear_q8 at decode's row counts against JAX's (1e-6 abs on O(1)
    outputs, as tests/test_torch_quant.py)."""
    from bsc_nav_tpu.ops import quant as jq
    rng = np.random.default_rng(M)
    w = (rng.normal(size=(96, 40)) / np.sqrt(96)).astype(np.float32)
    x = rng.normal(size=(M, 96)).astype(np.float32)
    want = jq.linear_q8(jnp.asarray(x), jq.quantize_weight(
        {"w": jnp.asarray(w)}))
    got = tq.linear_q8(torch.from_numpy(x),
                       tq.quantize_weight({"w": torch.from_numpy(w)}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
