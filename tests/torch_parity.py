"""Helpers shared by the PyTorch port's parity tests (tests/test_torch_*.py).

The port and the JAX package get the same numpy inputs; results come back
as numpy and are compared with a tolerance stated in each test.  The JAX
package's random draws are rebuilt from its key exactly as
``bsc_nav_tpu/memory/ingest.py`` and ``memory/pipeline.py`` make them, and
injected into the port, whose own draws come from a torch.Generator.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from bsc_nav_tpu.memory import ingest as jing
from bsc_nav_tpu_torch.memory.store import VoxelStoreState


def ingest_draws(key, cfg, B):
    """(pix [B, P], repl_idx [B*P]) that ``ingest_frames(..., key, cfg)``
    draws for a batch of B frames."""
    H, W = cfg.sensor.height, cfg.sensor.width
    P = jing.points_per_frame(cfg)
    keys = jax.random.split(key, B + 1)
    pix = np.stack([np.asarray(jing._select_pixels(keys[1 + b], H, W, P))
                    for b in range(B)])
    repl = np.array(jax.random.randint(       # a writable copy, for torch
        keys[0], (B * P,), 0, cfg.memory.cache_size, dtype=jnp.int32))
    return pix, repl


def build_step_draws(key, cfg, B):
    """(next key, pix, repl_idx) of one JAX ``build_step`` call: it splits
    its carry key first and ingests with the sub-key."""
    key, sub = jax.random.split(key)
    return (key,) + ingest_draws(sub, cfg, B)


U32 = 2.0 ** -24          # f32 unit roundoff


def _gamma(n):
    return n * U32 / (1 - n * U32)


def jax_frame_points(cfg, depth, poses, pix, inv_init=None):
    """(inv_calib, cam2world [B, 4, 4], p_local, p_world [B, P, 3],
    inv_init [4, 4]) of a batch of frames as ``bsc_nav_tpu/memory/
    ingest.py`` computes them inside its jitted ``ingest_frames`` (frame
    chain, backprojection, world transform; ``ingest.py:99-132``), jitted
    alone: the frame chain from ``poses[0]`` on a store's first batch
    (``inv_init`` None), else the store's chain ``inv_init``."""
    from bsc_nav_tpu import geometry as JG
    B, H, W = depth.shape
    hi = jax.lax.Precision.HIGHEST
    base = jnp.asarray(JG.base_axes_transform(), jnp.float32)
    b2c = jnp.asarray(JG.base_to_cam_transform(cfg.sensor.sensor_height),
                      jnp.float32)
    calib = jnp.asarray(JG.camera_intrinsics(H, W, cfg.sensor.hfov_deg),
                        jnp.float32)
    first = inv_init is None

    @jax.jit
    def stage(depth, poses, pix, inv_init):
        inv_calib = jnp.asarray(jnp.linalg.inv(calib), jnp.float32)
        if first:
            inv_init = JG.initial_base_inverse(poses[0], base)
        cam2world = jax.vmap(lambda p: JG.camera_to_world_transform(
            p, inv_init, base, b2c))(poses)
        z = jnp.take_along_axis(depth.reshape(B, H * W), pix, axis=1)
        uv1 = jnp.stack([(pix % W).astype(jnp.float32) + 0.5,
                         (pix // W).astype(jnp.float32) + 0.5,
                         jnp.ones_like(z)], axis=-1)
        rays = jnp.einsum("bpj,ij->bpi", uv1, inv_calib, precision=hi)
        p_local = rays * z[..., None]
        p_world = jnp.einsum("bpj,bij->bpi", p_local, cam2world[:, :3, :3],
                             precision=hi) + cam2world[:, None, :3, 3]
        return inv_calib, cam2world, p_local, p_world, inv_init

    out = stage(*map(jnp.asarray, (depth, poses.astype(np.float32), pix,
                                   np.eye(4, dtype=np.float32)
                                   if first else inv_init)))
    return tuple(np.array(a) for a in out)


def assert_frame_points_within_bound(cfg, depth, poses, pix):
    """The port's float geometry (``memory/ingest.frame_points`` on its own
    frame chain) against JAX's (``jax_frame_points``), each within a
    stated bound, not bit for bit: XLA's own bits for these products
    depend on the host codegen (fused multiply-add chains on some hosts,
    plain products on others) and on the compile mode (the JAX package's
    jitted and eager ``quat_to_rot`` differ).

    - cam2world: 64 ulps of (1 + its largest translation), per matrix:
      the quaternion rows (<= 8u each), the LU inverse of the first pose
      and two 4x4 products (<= gamma_4 each on unit rows, times |t| in
      the last column) put each evaluation within ~32u of the exact
      chain, so two evaluations within 64u.
    - A point a . b + c summed over n terms in f32, in any order, with or
      without FMA, lies within gamma_{n+1} (sum |a_j b_j| + |c|) of the exact
      value; two evaluations within twice that, plus the exact effect of
      their differing operands (measured, propagated).

    Returns JAX's (cam2world, p_local, p_world) as numpy."""
    from bsc_nav_tpu_torch import geometry as TG
    from bsc_nav_tpu_torch.memory import ingest as ting
    inv_calib, c2w, pl, pw, _ = jax_frame_points(cfg, depth, poses, pix)
    base = torch.as_tensor(TG.base_axes_transform(), dtype=torch.float32)
    b2c = torch.as_tensor(TG.base_to_cam_transform(cfg.sensor.sensor_height),
                          dtype=torch.float32)
    tposes = torch.from_numpy(np.array(poses, np.float32))
    t_c2w = TG.camera_to_world_transform(
        tposes, TG.initial_base_inverse(tposes[0], base), base, b2c)
    _, t_pl, t_pw = ting.frame_points(
        torch.from_numpy(np.array(depth)), torch.from_numpy(
            np.array(pix)).long(), t_c2w, cfg)
    f64 = lambda a: np.asarray(a, np.float64)
    t_c2w, t_pl, t_pw = f64(t_c2w), f64(t_pl), f64(t_pw)
    c2w, pl, pw = f64(c2w), f64(pl), f64(pw)

    scale = 1.0 + np.abs(c2w[:, :3, 3]).max(-1)[:, None, None]
    d_c2w = np.abs(t_c2w - c2w)
    assert np.all(d_c2w <= 64 * U32 * scale), (
        f"cam2world {(d_c2w / (U32 * scale)).max():.1f} ulps > 64")

    H, W = depth.shape[1:]
    t_inv = np.linalg.inv(np.float32(TG.camera_intrinsics(
        H, W, cfg.sensor.hfov_deg))).astype(np.float32)
    d_k = np.abs(f64(t_inv) - f64(inv_calib))
    z = f64(np.take_along_axis(np.asarray(depth).reshape(len(depth), -1),
                               np.asarray(pix), axis=1))[..., None]
    uv = np.stack([pix % W + 0.5, pix // W + 0.5, np.ones(pix.shape)], -1)
    bound_l = (2 * _gamma(4) * (np.abs(uv) @ np.abs(f64(inv_calib)).T)
               + np.abs(uv) @ d_k.T) * np.abs(z)
    d_l = np.abs(t_pl - pl)
    assert np.all(d_l <= bound_l), "p_local outside its bound"

    R, t = c2w[:, :3, :3], c2w[:, None, :3, 3]
    dR, dt = d_c2w[:, :3, :3], d_c2w[:, None, :3, 3]
    bound_w = (2 * _gamma(4) * (np.abs(pl) @ np.abs(R).transpose(0, 2, 1)
                                + np.abs(t))
               + d_l @ (np.abs(R) + dR).transpose(0, 2, 1)
               + np.abs(pl) @ dR.transpose(0, 2, 1) + dt)
    d_w = np.abs(t_pw - pw)
    assert np.all(d_w <= bound_w), (
        f"p_world outside its bound by {(d_w / bound_w).max():.2f}x")
    return (np.float32(c2w), np.float32(pl), np.float32(pw))


def tensors(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def store_fields_equal(jstate, tstate, cfg):
    """Assert the integer fields of a JAX store and a port store are equal,
    garbage rows excluded."""
    m = cfg.memory
    V, G = m.voxel_capacity, m.grid_size
    cut = {"slot_pos": V, "feat_count": V, "slot_map": -1,
           "cv_map": G * G, "max_height": G * G}
    for f in ("slot_pos", "feat_count", "slot_map", "cv_map", "max_height",
              "num_voxels", "dropped_voxels", "initialized"):
        a = np.asarray(getattr(jstate, f))
        b = getattr(tstate, f).cpu().numpy()
        if f in cut:
            a, b = a[:cut[f]], b[:cut[f]]
        np.testing.assert_array_equal(a, b, err_msg=f)


def assert_same_topk(pos_a, sc_a, pos_b, sc_b, atol):
    """Two top-K results agree: the same -inf padding, scores within
    ``atol``, and the same voxel set above the K-th score.  Voxels tied
    with the K-th score (within ``atol``) may differ: lax.top_k and
    torch.topk break ties differently, and a store whose voxels share
    tokens has many ties."""
    sc_a, sc_b = np.asarray(sc_a), np.asarray(sc_b)
    np.testing.assert_array_equal(np.isneginf(sc_a), np.isneginf(sc_b))
    live = np.isfinite(sc_a)
    np.testing.assert_allclose(sc_a[live], sc_b[live], atol=atol, rtol=0)
    assert np.all(np.diff(sc_a[live]) <= 0)
    kth = sc_a[live].min()

    def above(pos, sc):
        keep = live & (sc > kth + atol)
        return set(map(tuple, np.asarray(pos)[keep]))

    assert above(pos_a, sc_a) == above(pos_b, sc_b)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each element of x (8 significant
    bits)."""
    mag = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def tensor_core_tile(q, k, v, causal=False, drop_tile=None, keys=64):
    """The arithmetic order of the port's bf16 attention tiles in plain
    torch on q, k, v [B, H, S, hd] (numpy or torch), rounded to bf16
    first, ragged Sq and Sk and the square causal mask included: key tiles
    of ``keys`` -- 64 for bsc_nav_tpu_torch/csrc/attention_mma.cuh (K1,
    K3, K4, and K5 and K6 at other head_dims), 128 for attention_tma.cuh
    (K5 and K6 in bf16 at head_dim 64) -- f32 scores scaled by 1/sqrt(hd)
    after the dot, an online softmax with the running max, each p rounded
    to bf16 against that max before P @ V, the row sum of the unrounded p,
    and acc / l rounded to bf16.  ``drop_tile`` skips one key tile.
    Returns f32."""
    qf, kf, vf = (torch.as_tensor(a).to(torch.bfloat16).float()
                  for a in (q, k, v))
    Sq, Sk = qf.shape[2], kf.shape[2]
    scale = float(np.float32(1.0 / np.sqrt(qf.shape[3])))
    m = torch.full(qf.shape[:3], -torch.inf)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros_like(qf)
    rows = torch.arange(Sq)[:, None]
    for t, k0 in enumerate(range(0, Sk, keys)):
        if t == drop_tile:
            continue
        s = qf @ kf[:, :, k0:k0 + keys].transpose(-1, -2) * scale
        if causal:
            cols = torch.arange(k0, min(Sk, k0 + keys))[None, :]
            s = s.masked_fill(cols > rows, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + (p.to(torch.bfloat16).float()
                                       @ vf[:, :, k0:k0 + keys])
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16).float()


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero, on the bits: (bits + 2^12) with the low 13 bits cleared --
    what the port's f32 attention tile does (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple:
    """x = hi + lo + O(2^-22 |x|): hi = rna(x), lo = rna(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32x3_tile(q, k, v, causal=False, drop_tile=None, passes=3):
    """The arithmetic order of the port's f32 attention tile
    (bsc_nav_tpu_torch/csrc/attention_tf32.cuh, run by K1, K3, K5 and K6
    in f32) in plain torch on f32 q, k, v [B, H, S, hd] (numpy or torch),
    ragged Sq and Sk and the square causal mask included: q scaled by the
    f32 scale (1/sqrt(hd) rounded once from double) before the dot, every
    product of f32 operands a, b as three TF32 products a_lo b_hi +
    a_hi b_lo + a_hi b_hi (``tf32_split``, small terms first) summed in
    f32, 64-key tiles, an online softmax with the running max, P split
    like any operand before P @ V, the tile's P V added to the rescaled
    acc once, and acc / l.  Each pass runs over the whole tile in turn,
    as the tile's wgmma passes do (S; P V at hd <= 64); at hd > 64 the
    tile's mma.sync P V takes the three passes in turn per 8 keys, an
    order of f32 sums within the tile that this models but does not
    copy.  ``passes=1`` keeps only a_hi b_hi (one TF32 product);
    ``drop_tile`` skips one key tile."""
    qf, kf, vf = (torch.as_tensor(a).float() for a in (q, k, v))
    Sq, Sk = qf.shape[2], kf.shape[2]
    scale = float(np.float32(1.0 / np.sqrt(qf.shape[3])))

    def prod(a, b):
        (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
        if passes == 1:
            return ah @ bh
        return (al @ bh + ah @ bl) + ah @ bh

    qs = qf * scale
    m = torch.full(qf.shape[:3], -torch.inf)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros_like(qf)
    rows = torch.arange(Sq)[:, None]
    for t, k0 in enumerate(range(0, Sk, 64)):
        if t == drop_tile:
            continue
        s = prod(qs, kf[:, :, k0:k0 + 64].transpose(-1, -2))
        if causal:
            keys = torch.arange(k0, min(Sk, k0 + 64))[None, :]
            s = s.masked_fill(keys > rows, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # a row with no live key yet keeps m = -inf: no update, no NaN
        ms = torch.where(m_new == -torch.inf, 0.0, m_new)
        corr = torch.exp(m - ms)
        p = torch.exp(s - ms[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + prod(p, vf[:, :, k0:k0 + 64])
        m = m_new
    return acc / l[..., None]


def _round_toward_zero(t64: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 rounded toward zero (the tensor cores' accumulation)."""
    r = t64.float()
    over = r.double().abs() > t64.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def tensor_core_scan(feats, norms, counts, qs, fault=None):
    """The arithmetic order of K2b's tensor-core kernel
    (bsc_nav_tpu_torch/csrc/max_cosine.cu ``max_cosine_mma_kernel``) in
    plain torch on bf16 or int8 rows feats [V1*K, D], norms [V1*K] f32,
    counts [V1] int32 and queries qs [Q, D] f32 (numpy or torch) -> [Q, V1]
    f32: queries rounded to bf16, int8 codes widened exactly; D walked in
    k16 steps in the kernel's permuted order -- a k-block of 4 P values
    (P = 8 bf16 or 16 int8 values, one 16-byte load), whose step s takes
    values t P + 4 s .. t P + 4 s + 3 of each lane t of a quad -- each
    step's 16 exact products summed in f64 and added to the f32
    accumulator rounded toward zero (the tensor cores truncate); then
    acc / max(norm, 1e-12) in f32, -inf at k >= count, and the max over
    each voxel's K rows.

    ``fault`` makes the errors a check of this order must catch:
    "drop_step" skips the first k16 step, "unsigned" reads int8 codes as
    unsigned, "past_count" takes row k = count as live, "rows_only"
    permutes the rows' k and not the queries'."""
    f = torch.as_tensor(feats)
    if f.dtype == torch.int8:
        P, rows = 16, f.double()
        if fault == "unsigned":
            rows = torch.where(rows < 0, rows + 256, rows)
    else:
        P, rows = 8, f.to(torch.bfloat16).double()
    q = torch.as_tensor(qs).float().to(torch.bfloat16).double()
    VK, D = rows.shape
    KB = 4 * P
    pad = -D % KB
    rows = torch.nn.functional.pad(rows, (0, pad))
    q = torch.nn.functional.pad(q, (0, pad))
    # logical k i of a step: lane t = (i % 8) // 2 of the quad, value
    # 4 s + i % 2 (+ 2 for i >= 8) of its chunk
    i = torch.arange(16)
    lane_val = (i % 8) // 2 * P + i % 2 + 2 * (i // 8)
    steps = torch.stack([kb * KB + 4 * s + lane_val
                         for kb in range((D + pad) // KB)
                         for s in range(P // 4)])
    natural = torch.arange(D + pad).reshape(-1, 16)
    acc = torch.zeros(VK, q.shape[0])
    for n, (ri, qi) in enumerate(zip(
            steps, natural if fault == "rows_only" else steps)):
        if fault == "drop_step" and n == 0:
            continue
        acc = _round_toward_zero(acc.double() + rows[:, ri] @ q[:, qi].T)
    c = torch.as_tensor(counts).long()
    V1 = c.shape[0]
    K = VK // V1
    live = torch.arange(K)[None, :] < (c + int(fault == "past_count"))[:, None]
    cos = acc / torch.as_tensor(norms).float().clamp_min(1e-12)[:, None]
    cos = torch.where(live.reshape(VK, 1), cos, -torch.inf)
    return cos.reshape(V1, K, -1).amax(dim=1).T.contiguous()


def tf32x3_conv(x, w9, bias, act="silu", passes=3, drop_tap=None,
                bk=32):
    """The arithmetic order of K8's f32 path (conv3x3_s1.cu
    conv3x3_s1_tf32_kernel) in plain torch on f32 x [B, H, W, C] and w9
    [9, C, CO] (numpy or torch): the implicit GEMM walked tap by tap in
    ``bk``-channel slices (one ring stage each); every product of f32
    operands a, b as three TF32 products a_lo b_hi + a_hi b_lo + a_hi b_hi
    (``tf32_split``, small terms first), each pass over the slice's k8
    steps in turn, each k8 step one tensor-core accumulation -- its eight
    products exact, added to the running value and rounded toward zero --
    into a zeroed per-stage accumulator that is added to the result in
    f32 (rounded to nearest);
    then bias and x * sigmoid(x) when act is "silu".  ``passes=1`` keeps
    only a_hi b_hi (one TF32 product); ``drop_tap`` skips one of the nine
    taps.  Returns f32 [B, H, W, CO]."""
    xf = torch.as_tensor(x).float()
    w = torch.as_tensor(w9).float()
    B, H, W, C = xf.shape
    CO = w.shape[2]
    xp = torch.nn.functional.pad(xf, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(B * H * W, CO)
    for tap in range(9):
        if tap == drop_tap:
            continue
        dy, dx = divmod(tap, 3)
        a_all = xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, C)
        for c0 in range(0, C, bk):
            (ah, al), (bh, bl) = (tf32_split(a_all[:, c0:c0 + bk]),
                                  tf32_split(w[tap, c0:c0 + bk]))
            part = torch.zeros(B * H * W, CO, dtype=torch.float64)
            pairs = ((ah, bh),) if passes == 1 else (
                (al, bh), (ah, bl), (ah, bh))
            for a, b in pairs:
                for k in range(0, ah.shape[1], 8):
                    prod = a[:, k:k + 8].double() @ b[k:k + 8].double()
                    part = _round_toward_zero(part + prod).double()
            acc = acc + part.float()
    out = acc + torch.as_tensor(bias).float()
    if act == "silu":
        out = out * torch.sigmoid(out)
    return out.reshape(B, H, W, CO)


def numpy_tree(tree):
    """A JAX params tree as numpy leaves (writable copies)."""
    return jax.tree.map(lambda a: np.array(a), tree)


def fill_zero_mods(params, seed, std=0.5):
    """The JAX MMDiT's zero-initialised adaLN ``mod`` linears,
    ``final_mod`` and ``final_out`` filled with seeded values of std
    ``std / sqrt(fan_in)``, so attention reaches the output and a parity
    check of it can fail."""
    rng = np.random.default_rng(seed)

    def fill(p):
        fi, fo = p["w"].shape
        return {"w": jnp.asarray(rng.normal(size=(fi, fo)) * std
                                 / np.sqrt(fi), p["w"].dtype),
                "b": jnp.asarray(rng.normal(size=fo) * 0.1, p["b"].dtype)}

    out = dict(params)
    out["blocks"] = [{n: dict(blk[n], mod=fill(blk[n]["mod"]))
                      for n in ("x", "ctx")} for blk in params["blocks"]]
    out["final_mod"] = fill(params["final_mod"])
    out["final_out"] = fill(params["final_out"])
    return out


def _tensor(a, device="cpu") -> torch.Tensor:
    """A JAX or numpy array as a tensor (bf16 kept as bf16)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def store_from_jax(jstate, device="cpu") -> VoxelStoreState:
    """A port store holding a JAX store's arrays."""
    return VoxelStoreState(**{
        f: _tensor(getattr(jstate, f), device)
        for f in VoxelStoreState.__dataclass_fields__})


def segments_from_jax(jseg, store_dtype, device="cpu"):
    """A port ``SegmentedStore`` holding a JAX ``SegmentedStore``'s
    segments: the active and device segments as port stores, the spilled
    ones as dicts of tensors; the same policy (threshold, device segment
    count, freeze dtype)."""
    from bsc_nav_tpu_torch.memory.segments import SegmentedStore
    seg = SegmentedStore(jseg.cfg, store_dtype=store_dtype,
                         max_device_segments=jseg.max_device_segments,
                         freeze_dtype=jseg.freeze_dtype, device=device)
    seg.rotate_threshold = jseg.rotate_threshold
    seg.state = store_from_jax(jseg.state, device)
    seg.device_segments = [store_from_jax(s, device)
                           for s in jseg.device_segments]
    seg.host_segments = [
        {**{k: _tensor(h[k]) for k in ("feats", "feat_norm", "feat_count",
                                       "slot_pos")},
         "n": h["n"], "K": h["K"]} for h in jseg.host_segments]
    return seg


def inject_jax_build(tmem, cfg):
    """Wrap a port agent's build step so that each call takes the pixel
    and replacement draws and the world points of the JAX agent's build
    step at the same call (its key ``PRNGKey(cfg.seed)``, split once a
    call; points on axis-aligned walls sit on cell edges, where the last
    bit of XLA's products decides the voxel)."""
    carry = {"key": jax.random.PRNGKey(cfg.seed), "inv": None}
    build = tmem.perception.build_step

    def injected(c, params, rgb, depth, poses):
        carry["key"], pix, repl = build_step_draws(carry["key"], cfg,
                                                   rgb.shape[0])
        *_, pl, pw, carry["inv"] = jax_frame_points(
            cfg, depth.cpu().numpy(), poses.cpu().numpy(), pix, carry["inv"])
        return build(c, params, rgb, depth, poses,
                     pix=torch.from_numpy(pix), repl_idx=torch.from_numpy(repl),
                     points=(torch.from_numpy(pl), torch.from_numpy(pw)))

    tmem.perception.build_step = injected


def randomize_stats(params, seed):
    """Conv BN statistics, the BN-contrastive head's statistics, logit
    scales and biases from the seed, in place (numpy leaves)."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            if "bn_var" in node:
                co = node["bn_var"].shape[0]
                node["bn_scale"] = rng.uniform(0.5, 1.5, co).astype(np.float32)
                node["bn_bias"] = (0.1 * rng.normal(size=co)).astype(
                    np.float32)
                node["bn_mean"] = (0.1 * rng.normal(size=co)).astype(
                    np.float32)
                node["bn_var"] = rng.uniform(0.5, 2.0, co).astype(np.float32)
            for v in node.values():
                fill(v)
        elif isinstance(node, list):
            for v in node:
                fill(v)

    fill(params)
    for hp in params["head"]:
        hp["logit_scale"] = np.float32(rng.uniform(1.0, 2.0))
        hp["logit_bias"] = np.float32(rng.uniform(-1.0, 0.0))
    return params


def yolo_numpy_params(cfg, seed, text_dim):
    """JAX ``yolo_world.init_params`` as numpy leaves, with the statistics
    of ``randomize_stats``: conv BN statistics (so that K8's fold is not
    the identity) and the head's statistics, logit scales and biases (so
    that confidences do not all tie at sigmoid(-10))."""
    from bsc_nav_tpu.models import yolo_world as JY
    params = numpy_tree(JY.init_params(cfg, jax.random.PRNGKey(seed),
                                       text_dim=text_dim))
    return randomize_stats(params, seed)


# --------------------------------------------------------------------------
# a tiny local judge on disk (tests/test_torch_local_vlm.py,
# tests/test_torch_host_copies.py)
# --------------------------------------------------------------------------

JUDGE_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
                  "<|object_ref_start|>", "<|object_ref_end|>",
                  "<|box_start|>", "<|box_end|>", "<|quad_start|>",
                  "<|quad_end|>", "<|vision_start|>", "<|vision_end|>",
                  "<|vision_pad|>", "<|image_pad|>", "<|video_pad|>")
JUDGE_TEXTS = (
    "You are a helpful assistant.",
    "Judge whether the goal object in the image matches the description. "
    "Answer with 'Success: yes' or 'Success: no'; if it is too far, say "
    "'need forward: yes'.",
    "Which of these views shows the sofa? It's 2.5 m away; we'll turn 30 "
    "degrees.\n\nAnswer the question: what color is the bed?",
    "Décrivez la scène, s'il vous plaît: café, naïve, Ünïcödé.",
    "日本語のテキスト。東京の部屋にはベッドがある。 1234567890",
    "  runs   of\tspaces\r\n\r\nand new lines\n\n\n  ")


def build_qwen_tokenizer(vocab_size: int = 600, extra=()):
    """A byte-level BPE with Qwen2's pipeline (NFC, the Split pattern,
    ByteLevel without a prefix space, the ByteLevel decoder) trained on
    JUDGE_TEXTS, with Qwen2.5-VL's special tokens and non-special added
    tokens (``<tool_call>`` and ``extra``): a ``tokenizers.Tokenizer``."""
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                            normalizers, pre_tokenizers, processors,
                            trainers)
    from bsc_nav_tpu_torch.models.qwen_tokenizer import QWEN2_SPLIT_PATTERN
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_SPLIT_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(JUDGE_TEXTS * 8, trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken(s, normalized=False, special=True)
                            for s in JUDGE_SPECIALS])
    tok.add_tokens([AddedToken(t, normalized=False, special=False)
                    for t in ("<tool_call>",) + tuple(extra)])
    return tok


def tiny_judge_configs(tok):
    """(JAX config, port config) of a tiny Qwen2.5-VL whose vocabulary and
    image ids are the tokenizer's, with the 3B's patch (14) and window
    (112), so a 224^2 image is 64 merged tokens in 4 windows."""
    import dataclasses
    from bsc_nav_tpu.models import qwen_vl as JQ
    from bsc_nav_tpu_torch.models import qwen_vl as TQ
    kw = dict(
        text=dict(hidden=24, layers=2, heads=4, kv_heads=2, intermediate=48,
                  vocab=tok.get_vocab_size(with_added_tokens=True),
                  mrope_section=(1, 1, 1)),
        vision=dict(depth=2, hidden=32, heads=2, patch=14, temporal_patch=2,
                    merge=2, out_hidden=24, intermediate=40, window=112,
                    fullatt=(1,)),
        image_token_id=tok.token_to_id("<|image_pad|>"),
        vision_start_token_id=tok.token_to_id("<|vision_start|>"),
        tie_word_embeddings=False)
    out = []
    for M in (JQ, TQ):
        out.append(M.QwenVLConfig(
            text=M.QwenVLTextConfig(**kw["text"]),
            vision=M.QwenVLVisionConfig(**kw["vision"]),
            **{k: v for k, v in kw.items() if k not in ("text", "vision")}))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return tuple(out)


def write_tiny_judge(path, seed: int = 0, answer=None):
    """``qwen_vl.npz`` (the flat layout of ``save_params_npz``; weights of
    std 0.2, random biases and norm scales), ``tokenizer.json`` and the
    ``tokenizer_config.json`` that ``AutoTokenizer`` reads, in ``path``.
    With ``answer``, the tokenizer has it as one added token, and the
    weights make it the first token after any chat prompt (which ends in
    "\n"): the newline's embedding has 30 in channel 0, and ``lm_head``
    reads channel 0 into the answer's logit with weight 20, which the
    random rest (O(1) logits) cannot outweigh; the tokens after it are the
    random model's.  Returns (JAX config, port config)."""
    import json
    import os
    from bsc_nav_tpu.models import qwen_vl as JQ
    from bsc_nav_tpu_torch.models.weights import flatten_params
    tok = build_qwen_tokenizer(extra=(answer,) if answer else ())
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "clean_up_tokenization_spaces": False,
                   "model_max_length": 32768}, f)
    jcfg, tcfg = tiny_judge_configs(tok)
    rng = np.random.default_rng(seed)
    flat = flatten_params(jax.tree_util.tree_map(
        np.asarray, JQ.init_params(jcfg, None)))
    norms = ("norm1", "norm2", "ln_q", "ln1", "ln2", "norm")
    for k, v in flat.items():
        name = k.rsplit(".", 1)[-1]
        flat[k] = ((1 + 0.1 * rng.normal(size=v.shape)) if name in norms
                   else 0.05 * rng.normal(size=v.shape) if name.endswith("_b")
                   else 0.2 * rng.normal(size=v.shape)).astype(np.float32)
    if answer:
        flat["embed"][tok.token_to_id("\u010a"), 0] = 30.0     # "\n"
        flat["lm_head"][0, tok.token_to_id(answer)] = 20.0
    np.savez(os.path.join(path, "qwen_vl.npz"), **flat)
    return jcfg, tcfg
