#!/usr/bin/env python3
"""Drive the PyTorch port's memory spine, CLIP stack and text query once on
one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N]

Phases, one line each (any failed check raises, so the script exits
non-zero):

  build         compile bsc_nav_tpu_torch/csrc/*.cu with nvcc for sm_90a
  kernels       K1 short_attention_qkv, K2 max_cosine_per_voxel, K3
                short_attention and K4 joint_qkv_attention against their
                plain PyTorch versions on the card, at the main paths'
                shapes, with both times (CUDA events, median of 20 runs),
                the bound reckoned from each case's bytes and operations,
                and one PyTorch call computing the same function where one
                exists (SDPA for K1 and K3); K1 also at the CLIP vision
                shape, for comparison with K3
  slice f32     the full default Config() -- 680x680 RGB-D, 1000^2 x 200
                grid, 131,080 slots x 10 tokens x 1024 -- through
                Perception / VoxelTokenMemory with a random-init DINOv2
                ViT-L/14-reg: 32 frames (4 flushes of 8), then 3 image
                queries of 3 images (one with a region radius); launch
                counts, store and top-K checks, times per flush and query
  slice bf16    the same with bf16 weights, compute and store
  slice-parity  small_test_config() and a tiny ViT (head_dim 16, routed to
                K3 as in the JAX package): the same frames and injected
                draws on the CPU (plain versions) and on the card (kernels);
                equal store, equal top-K
  clip          MetaCLIP ViT-H/14 at full width (random init, f32) beside
                the default Config() store: CLIPMatcher with quantize off
                and on (score over the 12 views of a turn in place with a
                text and an image prompt, best over the 21 HM3D classes),
                then ClipPatchDetector feeding VoxelTokenMemory's long-term
                memory over the 32 frames (4 flushes), at 0.55 and again
                at the 99th percentile of the heat a random-init tower
                gives; K3 in every CLIP layer, K1 never from a CLIP call
  clip-parity   a small CLIP keeping head_dim 80 (vision) and a causal
                head_dim 64 text tower: embeddings and scores, f32 and
                int8, on the card against the CPU, and the detector's
                long-term instances over small_test_config() frames equal
  textq bf16    the text query at full width: SD3.5-medium (24 blocks x
                1536, dual attention in blocks 0-12), the SD3 CLIP-L/G text
                towers, the T5-XXL encoder at 512 tokens and the SD3 VAE
                decoder, random bf16 weights from the seed, 3 images of
                512^2, 28 steps, CFG 7.0, inside VoxelTokenMemory(Config())
                over the 32 frames: voxel_localized("a sofa") twice, then
                once under torch.profiler; 1,036 K4 launches per query
  textq int8    the same with the MMDiT token matmuls in W8A8 and T5-XXL
                quantized on the host (quantize_params_host), the default
                diffusion_int8=True
  textq-parity  a small imagination (MMDiT head_dim 64 on K4's route, a
                dual block, a context_pre_only last block; tiny T5, CLIP
                towers, VAE and ViT) on the card against the CPU with the
                same injected noise: velocity, latents, images within 1
                level, equal top-K

The last two lines are a JSON object of the kernels' launch counts, errors
and times, and {"ok": true, "device": {...}}.  Without CUDA it exits 1 and
prints no result.  JAX is never imported.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES, BATCH, N_QUERIES, QUERY_IMAGES = 32, 8, 3, 3
N_VIEWS, SCORE_REPS = 12, 4     # a 360-degree turn at 30 degrees a step
K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
K3_TOL = 2e-5           # f32 abs; bf16: 2e-5 plus one bf16 ulp per element
CLIP_TOL = 1e-4         # unit features and scores, f32 CLIP on card vs CPU
# int8 towers, card vs CPU: an activation within ~1e-6 of a rounding
# boundary may take the neighbouring code on one side; one flip moves a
# unit feature by up to a few 1e-3 (tests/test_torch_clip.py INT8_TOL)
INT8_TOL, INT8_MIN_COS = 1e-2, 0.9995
K2_TOL = 2e-5           # abs, beside 1e-5 rel (zero-norm rows / 1e-12)
K4_TOL = 2e-5           # f32 abs; bf16: 2e-5 plus one bf16 ulp per element
PARITY_TOL = 1e-4       # top-K scores, f32 slice on card vs CPU
# small imagination, f32 on the card (TF32 off, K4) against the CPU (plain
# versions): sums in other orders through 2 blocks give velocities within
# 5e-4 of ~3; 3 CFG steps at scale 4 amplify that to 2e-3 in the latents
TEXTQ_V_TOL, TEXTQ_LAT_TOL = 5e-4, 2e-3
# H100 SXM dense peaks (data sheet): f32 outside the tensor cores, bf16 on
# them, TF32 for the f32 line's context; HBM rate
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TF32_FLOPS, HBM_BYTES_PER_S = 495e12, 3.35e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one CUDA event pair per run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def counts():
    """Launch counts of (K1, K2, K3, K4)."""
    from bsc_nav_tpu_torch.ops import flash_attention, similarity
    return (flash_attention.short_attention_qkv.launches,
            similarity.max_cosine_per_voxel.launches,
            flash_attention.short_attention.launches,
            flash_attention.joint_qkv_attention.launches)


def since(before):
    return tuple(a - b for a, b in zip(counts(), before))


def reset_counts() -> None:
    from bsc_nav_tpu_torch.ops import flash_attention, similarity
    flash_attention.short_attention_qkv.launches = 0
    similarity.max_cosine_per_voxel.launches = 0
    flash_attention.short_attention.launches = 0
    flash_attention.joint_qkv_attention.launches = 0


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each element of x."""
    mag = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def unit_cos(a: np.ndarray, b: np.ndarray) -> float:
    return float((a * b).sum(-1).min())


def bound(flops: float, n_bytes: float, dtype) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for this work, the larger of flops over the dtype's peak and bytes
    over the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_flops(B, H, Sq, Sk, hd, causal=False) -> float:
    """4 * hd flops per (query, key) pair attended: QK^T and PV."""
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
    return 4.0 * B * H * pairs * hd


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sdpa_ms(q, k, v, causal=False) -> float:
    """One torch.nn.functional.scaled_dot_product_attention call on the
    same [B, H, S, hd] inputs: the library yardstick, timed only."""
    import torch.nn.functional as F
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def phase_kernels(dev, gen):
    from bsc_nav_tpu_torch.ops import flash_attention as fa
    from bsc_nav_tpu_torch.ops import similarity as sim

    cases = []
    for B in (8, 32):
        for dtype in (torch.float32, torch.bfloat16):
            S, H, hd = 261, 16, 64
            qkv = torch.randn(B, S, 3 * H * hd, generator=gen, device=dev
                              ).to(dtype)
            got = fa.short_attention_qkv(qkv, H)
            want = fa.short_attention_qkv_reference(qkv, H)
            err = (got.float() - want.float()).abs().max().item()
            ms = cuda_ms(lambda: fa.short_attention_qkv(qkv, H))
            plain = cuda_ms(lambda: fa.short_attention_qkv_reference(qkv, H))
            lib = sdpa_ms(*(t.contiguous() for t in fa._split_heads(qkv, H)))
            b_ms, b_by = bound(attn_flops(B, H, S, S, hd),
                               nbytes(qkv, got), dtype)
            tol = K1_TOL[dtype]
            log("kernels", f"K1 short_attention_qkv B={B} S={S} {H}x{hd} "
                f"{str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol}) "
                f"kernel {ms:.4f} ms plain {plain:.4f} ms sdpa {lib:.4f} ms "
                f"bound {b_ms:.4f} ms ({b_by})")
            check(err <= tol, f"K1 B={B} {dtype}: err {err} > {tol}")
            cases.append({"kernel": "K1", "B": B, "S": S, "heads": H,
                          "head_dim": hd, "dtype": str(dtype)[6:],
                          "max_abs_err": err, "tol": tol, "ms": ms,
                          "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib})
            del qkv, got, want

    V1, K, D = 131_080, 10, 1024
    feats = torch.randn(V1 * K, D, generator=gen, device=dev)
    norms = torch.linalg.norm(feats, dim=1)
    cnt = torch.randint(0, K + 1, (V1,), generator=gen, device=dev,
                        dtype=torch.int32)
    q = torch.randn(D, generator=gen, device=dev)
    q = q / torch.linalg.norm(q)
    for dtype in (torch.float32, torch.bfloat16):
        f = feats.to(dtype)
        got = sim.max_cosine_per_voxel(f, norms, cnt, q)
        want = sim.reference_max_cosine(f, norms, cnt, q)
        check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
              f"K2 {dtype}: -inf pattern differs")
        live = torch.isfinite(want)
        diff = (got[live] - want[live]).abs()
        err = diff.max().item()
        check(bool((diff <= K2_TOL + 1e-5 * want[live].abs()).all()),
              f"K2 {dtype}: err {err}")
        ms = cuda_ms(lambda: sim.max_cosine_per_voxel(f, norms, cnt, q))
        plain = cuda_ms(lambda: sim.reference_max_cosine(f, norms, cnt, q))
        store_bytes = nbytes(f)
        # the scan reads only live rows (k < count): count what this
        # store's counts need -- rows and their norms, counts, q, output
        live = int(cnt.sum())
        b_ms, b_by = bound(2.0 * D * live,
                           live * (D * f.element_size() + 4)
                           + nbytes(cnt, q, got), dtype)
        log("kernels", f"K2 max_cosine_per_voxel V1={V1} K={K} D={D} "
            f"{str(dtype)[6:]} store {store_bytes / 1e9:.2f} GB ({live:,} "
            f"live rows): max_abs_err {err:.3g} (tol {K2_TOL} abs + 1e-5 "
            f"rel) kernel {ms:.4f} ms plain {plain:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}); no one PyTorch call computes a "
            f"per-voxel max over a count mask")
        cases.append({"kernel": "K2", "V1": V1, "K": K, "D": D,
                      "dtype": str(dtype)[6:], "store_bytes": store_bytes,
                      "live_rows": live, "max_abs_err": err, "tol": K2_TOL,
                      "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None})
        del f, got, want
    del feats, norms, cnt, q

    # K3 at the CLIP towers' shapes: the vision tower at B 12 (check_around's
    # 12 views), the causal text tower at B 22 (a prompt and the 21 labels),
    # and a ragged non-causal case (Sq != Sk, Sk not a multiple of 8)
    for case, B, H, Sq, Sk, hd, causal in (
            ("vision", 12, 16, 257, 257, 80, False),
            ("text", 22, 16, 77, 77, 64, True),
            ("ragged", 4, 16, 50, 203, 80, False)):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, Sq, hd, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(B, H, Sk, hd, generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
            got = fa.short_attention(q, k, v, causal)
            want = fa.short_attention_reference(q, k, v, causal)
            diff = (got.float() - want.float()).abs()
            tol = K3_TOL + (bf16_ulp(want) if dtype == torch.bfloat16 else 0)
            err = diff.max().item()
            check(bool((diff <= tol).all()), f"K3 {case} {dtype}: err {err}")
            ms = cuda_ms(lambda: fa.short_attention(q, k, v, causal))
            plain = cuda_ms(
                lambda: fa.short_attention_reference(q, k, v, causal))
            lib = sdpa_ms(q, k, v, causal)
            b_ms, b_by = bound(attn_flops(B, H, Sq, Sk, hd, causal),
                               nbytes(q, k, v, got), dtype)
            log("kernels", f"K3 short_attention {case} B={B} {H}x{hd} "
                f"Sq={Sq} Sk={Sk} causal={causal} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g} (tol {K3_TOL}"
                f"{' + 1 bf16 ulp' if dtype == torch.bfloat16 else ''}) "
                f"kernel {ms:.4f} ms plain {plain:.4f} ms sdpa {lib:.4f} ms "
                f"bound {b_ms:.4f} ms ({b_by})")
            cases.append({"kernel": "K3", "case": case, "B": B, "heads": H,
                          "Sq": Sq, "Sk": Sk, "head_dim": hd,
                          "causal": causal, "dtype": str(dtype)[6:],
                          "max_abs_err": err, "tol": K3_TOL, "ms": ms,
                          "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib})
            del q, k, v, got, want, diff

    # K1 at the CLIP vision shape, from a fused qkv: the JAX dispatch sends
    # this shape to K3 (head_dim 80), K1 is timed beside it for comparison
    for dtype in (torch.float32, torch.bfloat16):
        B, S, H, hd = 12, 257, 16, 80
        qkv = torch.randn(B, S, 3 * H * hd, generator=gen, device=dev
                          ).to(dtype)
        got = fa.short_attention_qkv(qkv, H)
        err = (got.float() - fa.short_attention_qkv_reference(qkv, H).float()
               ).abs().max().item()
        check(err <= K1_TOL[dtype], f"K1 vision shape {dtype}: err {err}")
        ms = cuda_ms(lambda: fa.short_attention_qkv(qkv, H))
        plain = cuda_ms(lambda: fa.short_attention_qkv_reference(qkv, H))
        b_ms, b_by = bound(attn_flops(B, H, S, S, hd), nbytes(qkv, got),
                           dtype)
        log("kernels", f"K1 short_attention_qkv at the CLIP vision shape "
            f"B={B} S={S} {H}x{hd} {str(dtype)[6:]}: max_abs_err {err:.3g} "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms bound {b_ms:.4f} ms "
            f"({b_by})")
        cases.append({"kernel": "K1", "case": "clip-vision-shape", "B": B,
                      "S": S, "heads": H, "head_dim": hd,
                      "dtype": str(dtype)[6:], "max_abs_err": err,
                      "tol": K1_TOL[dtype], "ms": ms, "plain_ms": plain,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None})
        del qkv, got
    k4_cases(dev, gen, cases)
    torch.cuda.empty_cache()
    return cases


def normalised_qkv(x, c, heads, g, eps=1e-6):
    """[B, H, S, 64] q, k, v of K4's inputs with the qk-norm applied (q not
    scaled), in the input dtype: what SDPA would need to compute K4."""
    from bsc_nav_tpu_torch.ops import flash_attention as fa
    Sx, Sc = x.shape[1], c.shape[1]
    q, k, v = fa._split_heads(torch.cat([x, c], dim=1).float(), heads)

    def rms(t, g_x, g_c):
        return (t * torch.rsqrt(t.square().mean(-1, keepdim=True) + eps)
                * fa._stream_gammas(g_x, g_c, Sx, Sc, 64))

    return (rms(q, g[0], g[2]).to(x.dtype).contiguous(),
            rms(k, g[1], g[3]).to(x.dtype).contiguous(),
            v.to(x.dtype).contiguous())


def k4_cases(dev, gen, cases):
    """K4 at the SD3.5-medium shapes: B 6 (3 images x CFG 2), 24 heads x
    64, 1024 latent rows plus 77 CLIP + 512 T5 context rows, 77 + 77 when
    T5 is absent, and the dual-attention self-attention (no context)."""
    from bsc_nav_tpu_torch.ops import flash_attention as fa

    B, Sx, H = 6, 1024, 24
    D = H * 64
    for case, Sc in (("joint", 589), ("joint-no-t5", 154), ("self", 0)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(B, Sx, 3 * D, generator=gen, device=dev).to(dtype)
            c = torch.randn(B, Sc, 3 * D, generator=gen, device=dev).to(dtype)
            g = [torch.rand(64, generator=gen, device=dev) * 1.5 + 0.25
                 for _ in range(4)]
            got = fa.joint_qkv_attention(x, c, H, *g)
            want = fa.joint_qkv_attention_reference(x, c, H, *g)
            diff = (got.float() - want.float()).abs()
            tol = K4_TOL + (bf16_ulp(want) if dtype == torch.bfloat16 else 0)
            err = diff.max().item()
            check(bool((diff <= tol).all()), f"K4 {case} {dtype}: err {err}")
            ms = cuda_ms(lambda: fa.joint_qkv_attention(x, c, H, *g))
            plain = cuda_ms(
                lambda: fa.joint_qkv_attention_reference(x, c, H, *g))
            qn, kn, vn = normalised_qkv(x, c, H, g)
            sdpa = sdpa_ms(qn, kn, vn)
            S = Sx + Sc
            flops = attn_flops(B, H, S, S, 64)
            b_ms, b_by = bound(flops, nbytes(x, c, got, *g), dtype)
            tf32 = (f", {flops / TF32_FLOPS * 1e3:.4f} ms at the TF32 rate"
                    if dtype == torch.float32 else "")
            log("kernels", f"K4 joint_qkv_attention {case} B={B} {H}x64 "
                f"Sx={Sx} Sc={Sc} (S {S}) {str(dtype)[6:]}: max_abs_err "
                f"{err:.3g} (tol {K4_TOL}"
                f"{' + 1 bf16 ulp' if dtype == torch.bfloat16 else ''}) "
                f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) plain "
                f"{plain:.4f} ms bound {b_ms:.4f} ms ({b_by}{tf32}); no "
                f"PyTorch call applies the qk-norm -- for context only, SDPA "
                f"on the already-normalised q/k/v {sdpa:.4f} ms")
            cases.append({"kernel": "K4", "case": case, "B": B, "heads": H,
                          "Sx": Sx, "Sc": Sc, "head_dim": 64,
                          "dtype": str(dtype)[6:], "max_abs_err": err,
                          "tol": K4_TOL, "ms": ms, "plain_ms": plain,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None,
                          "sdpa_on_normalised_ms": sdpa})
            del x, c, got, want, diff, qn, kn, vn
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase: slice at the full default config
# ---------------------------------------------------------------------------

def render_world(cfg, seed):
    """32 frames turning in place, and 3 query groups of 3 close-up views
    of the scene's first three boxes, from the fake environment."""
    from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat

    env, frames = spin_frames(cfg, seed, N_FRAMES)
    queries = []
    for box in env.scene.boxes[:N_QUERIES]:
        c = np.asarray(box.center)
        look_from = c + np.array([-0.8, -c[1], -0.8])
        yaw = math.atan2(-(c[0] - look_from[0]), -(c[2] - look_from[2]))
        env.agent.set_state(AgentState(look_from, Quat.from_yaw(yaw)))
        imgs = []
        for _ in range(QUERY_IMAGES):
            imgs.append(env.step("look_down")["rgb"][:, :, :3])
        queries.append(np.stack(imgs))
    env.reset(init_state=AgentState(np.zeros(3), Quat.from_yaw(0.0)),
              build_map=True)
    return env, frames, queries


def phase_slice(dev, dtype, cfg, vcfg, world, seed):
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.memory.store import store_nbytes
    from bsc_nav_tpu_torch.models import vit

    name = f"slice {str(dtype)[6:]}"
    env, frames, queries = world
    torch.cuda.reset_peak_memory_stats()
    params = vit.init_params(
        vcfg, torch.Generator(device=dev).manual_seed(seed), dtype=dtype,
        device=dev)
    perception = Perception.create(cfg, vit_params=params,
                                   batch_size=BATCH, compute_dtype=dtype,
                                   device=dev)
    mem = VoxelTokenMemory(cfg, env, perception, store_dtype=dtype)
    torch.cuda.synchronize()
    log(name, f"store {store_nbytes(cfg.memory, dtype) / 1e9:.2f} GB "
        f"(reckoned from shapes; feats {tuple(mem.state.feats.shape)}, "
        f"slot_map {mem.state.slot_map.numel():,} int32)")

    flush_ms = []
    for i in range(N_FRAMES // BATCH):
        before = counts()
        t0 = time.perf_counter()
        for obs, pose in frames[i * BATCH:(i + 1) * BATCH]:
            mem.push_frame(obs, pose)              # the 8th push flushes
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        d = since(before)
        check(d == (vcfg.depth, 0, 0, 0),
              f"flush {i}: K1-K4 +{d} (want +{vcfg.depth}, +0, +0, +0)")
    nv = int(mem.state.num_voxels)
    check(nv > 0, "no voxels after 32 frames")
    check(int(mem.state.feat_count[:nv].min()) >= 1, "empty live voxel")

    query_ms, best = [], None
    for i, imgs in enumerate(queries):
        before = counts()
        radius = 50.0 if i == N_QUERIES - 1 else np.inf
        t0 = time.perf_counter()
        out = mem.voxel_localized(imgs, K=cfg.query.top_k,
                                  region_radius=radius, curr_grid=best)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        d = since(before)
        check(d == (vcfg.depth, 1, 0, 0),
              f"query {i}: K1-K4 +{d} (want +{vcfg.depth}, +1, +0, +0)")
        b, pos, sims = out
        check(len(pos) > 0, f"query {i}: empty top-K")
        check(bool(np.isfinite(sims).all()), f"query {i}: non-finite")
        check(bool((np.abs(sims) <= 1 + 1e-5).all()),
              f"query {i}: score outside [-1, 1]")
        check(bool((np.diff(sims) <= 0).all()), f"query {i}: not sorted")
        if np.isfinite(radius):
            d2r = ((pos - best) ** 2).sum(axis=1)
            check(bool((d2r <= radius ** 2).all()),
                  f"query {i}: voxel outside the region")
        best = b[0] if best is None else best
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(name, f"num_voxels {nv} dropped {int(mem.state.dropped_voxels)}; "
        f"flush ms (8 frames each) {[round(t, 3) for t in flush_ms]}; "
        f"steady median {statistics.median(flush_ms[1:]):.3f}; query ms "
        f"({QUERY_IMAGES} images, top-{cfg.query.top_k}) "
        f"{[round(t, 3) for t in query_ms]}; peak device memory "
        f"{peak:.2f} GB")
    result = {"dtype": str(dtype)[6:], "num_voxels": nv,
              "flush_ms": flush_ms, "query_ms": query_ms,
              "peak_gb": peak}
    del mem, perception, params
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase: slice parity, card against CPU
# ---------------------------------------------------------------------------

def phase_parity(dev, seed):
    from bsc_nav_tpu_torch.config import small_test_config
    from bsc_nav_tpu_torch.memory import pipeline
    from bsc_nav_tpu_torch.memory.ingest import points_per_frame
    from bsc_nav_tpu_torch.memory.store import init_store
    from bsc_nav_tpu_torch.models import vit

    cfg = small_test_config()
    vcfg = vit.ViTConfig(img_size=28, patch_size=14, dim=32, depth=2,
                         heads=2, num_registers=1)
    rng = np.random.default_rng(seed)
    B, H, W = 8, cfg.sensor.height, cfg.sensor.width
    P = points_per_frame(cfg)
    rgb = rng.integers(0, 255, size=(B, H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0.3, 4.0, size=(B, H, W)).astype(np.float32)
    poses = np.zeros((B, 7), np.float32)
    poses[:, :3] = rng.uniform(-1, 1, size=(B, 3))
    poses[:, 3:] = rng.normal(size=(B, 4))
    pix = rng.integers(0, H * W, size=(B, P))
    repl = rng.integers(0, cfg.memory.cache_size, size=B * P)
    qimgs = rng.integers(0, 255, size=(3, 28, 28, 3), dtype=np.uint8)
    cpu_model = vit.init_params(vcfg, torch.Generator().manual_seed(seed),
                                device="cpu")
    card_model = vit.ViT(vcfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())

    def run(d, model):
        t = [torch.from_numpy(a).to(d)
             for a in (rgb, depth, poses, pix, repl, qimgs)]
        (state, _), _ = pipeline.make_build_step(cfg, vcfg)(
            (init_store(cfg.memory, device=d), None), model, *t[:3],
            pix=t[3], repl_idx=t[4])
        pos, sc = pipeline.make_query_step(cfg, vcfg)(state, model, t[5],
                                                      top_k=16)
        return state, pos.cpu().numpy(), sc.cpu().numpy()

    (cs, cpos, csc), (gs, gpos, gsc) = run("cpu", cpu_model), run(dev,
                                                                  card_model)
    V, G = cfg.memory.voxel_capacity, cfg.memory.grid_size
    for f, n in (("slot_pos", V), ("feat_count", V), ("slot_map", -1),
                 ("cv_map", G * G), ("max_height", G * G),
                 ("num_voxels", None)):
        a, b = getattr(cs, f), getattr(gs, f).cpu()
        if n is not None:
            a, b = a[:n], b[:n]
        check(torch.equal(a, b), f"slice-parity: {f} differs")
    check(bool(np.isfinite(csc).all()), "slice-parity: -inf in top-K")
    err = float(np.abs(gsc - csc).max())
    check(err <= PARITY_TOL, f"slice-parity: score err {err}")
    kth = csc.min()     # ties at the K-th score may order either way
    above = [set(map(tuple, p[s > kth + PARITY_TOL]))
             for p, s in ((cpos, csc), (gpos, gsc))]
    check(above[0] == above[1], "slice-parity: top-K sets differ")
    log("slice-parity", f"small_test_config, ViT dim 32 x 2 heads (hd 16): "
        f"{int(gs.num_voxels)} voxels, integer store equal, top-16 equal, "
        f"max score err {err:.3g} (tol {PARITY_TOL})")
    return err


# ---------------------------------------------------------------------------
# phase: the CLIP stack at full width
# ---------------------------------------------------------------------------

def phase_clip(dev, cfg, vcfg, world, seed):
    """MetaCLIP ViT-H/14 matcher (f32 and int8) and CLIP-patch detector ->
    long-term memory, beside the default Config() store."""
    from bsc_nav_tpu_torch.config import HM3D_DETECT_CLASSES
    from bsc_nav_tpu_torch.models.tokenizer import default_tokenizer
    from bsc_nav_tpu_torch.agents.matchers import CLIPMatcher
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import vit
    from bsc_nav_tpu_torch.models.detector import ClipPatchDetector

    env, frames, queries = world
    ccfg = C.CONFIGS[cfg.models.clip]
    check((ccfg.vision_width, ccfg.vision_layers, ccfg.vision_heads,
           ccfg.text_width, ccfg.text_layers) == (1280, 32, 16, 1024, 24),
          "the default CLIP is not MetaCLIP ViT-H/14")
    check(round(360 / cfg.actions.turn_left_deg) == N_VIEWS,
          "check_around does not take 12 views")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clip = C.init_params(ccfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in clip.parameters())
    log("clip", f"MetaCLIP ViT-H/14 random init on {dev}: {n_params / 1e9:.3f}"
        f" G parameters, {n_params * 4 / 1e9:.2f} GB f32, "
        f"{time.perf_counter() - t0:.1f} s")
    tok = default_tokenizer()          # hash tokenizer: no BPE vocab here
    views = [obs["rgb"] for obs, _ in frames[:N_VIEWS]]
    labels = list(HM3D_DETECT_CLASSES)
    L_v, L_t = ccfg.vision_layers, ccfg.text_layers
    result, view_feats = {}, {}
    for quantize in (False, True):
        name = "int8" if quantize else "f32"
        m = CLIPMatcher(clip, ccfg, tok, quantize=quantize, device=dev)
        before, score_ms = counts(), []
        for _ in range(SCORE_REPS):
            t0 = time.perf_counter()
            s_txt = m.score(views, "a bed")        # host numpy: synced
            score_ms.append((time.perf_counter() - t0) * 1e3)
        d = since(before)
        # the prompt's text embedding is computed once, then cached
        check(d == (0, 0, SCORE_REPS * L_v + L_t, 0),
              f"clip {name} score: K1-K4 +{d}")
        before = counts()
        s_img = m.score(views, queries[0][0])
        best = m.best("bed", labels)
        d = since(before)
        check(d == (0, 0, 2 * L_v + 2 * L_t, 0),
              f"clip {name} image score + best: K1-K4 +{d}")
        for s in (s_txt, s_img):
            check(s.shape == (N_VIEWS,) and bool(np.isfinite(s).all())
                  and abs(float(s.sum()) - 1) < 1e-4,
                  f"clip {name}: bad scores {s}")
        check(0 <= best < len(labels), f"clip {name}: best {best}")
        view_feats[name] = m._embed_views(views)
        steady = statistics.median(score_ms[1:])
        log("clip", f"CLIPMatcher {name}: score ({N_VIEWS} views, text "
            f"prompt) ms {[round(t, 3) for t in score_ms]}, steady median "
            f"{steady:.3f}; best('bed') = {labels[best]!r}")
        result[name] = {"score_ms": score_ms, "score_steady_ms": steady,
                        "best": labels[best]}
        del m
    cos = unit_cos(view_feats["f32"], view_feats["int8"])
    log("clip", f"int8 vs f32 view features: min cosine {cos:.5f}")
    check(cos > 0.9, f"int8 view features drift: cosine {cos}")
    result["int8_vs_f32_min_cos"] = cos
    torch.cuda.empty_cache()

    det = ClipPatchDetector(clip, ccfg, tok, labels,
                            confidence=cfg.detector.confidence, device=dev)
    n_dets = []
    detect_batch = det.detect_batch

    def counted(rgbs):
        out = detect_batch(rgbs)
        n_dets.append(sum(map(len, out)))
        return out

    det.detect_batch = counted
    params = vit.init_params(
        vcfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    perception = Perception.create(cfg, vit_params=params, batch_size=BATCH,
                                   device=dev)
    mem = VoxelTokenMemory(cfg, env, perception, detector=det)
    flush_ms = []
    for i in range(N_FRAMES // BATCH):
        before = counts()
        t0 = time.perf_counter()
        for obs, pose in frames[i * BATCH:(i + 1) * BATCH]:
            mem.push_frame(obs, pose)              # the 8th push flushes
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        d = since(before)
        check(d == (vcfg.depth, 0, L_v - 1, 0),
              f"detector flush {i}: K1-K4 +{d} (want +{vcfg.depth}, "
              f"+0, +{L_v - 1}, +0)")
    inst = mem.long_memory_dict
    G, Z = cfg.memory.grid_size, cfg.memory.zmax - cfg.memory.zmin
    check(all(o["label"] in labels and 0 <= o["loc"][0] < G
              and 0 <= o["loc"][1] < G and 0 <= o["loc"][2] < Z
              and cfg.detector.confidence <= o["confidence"] <= 1
              for o in inst), "malformed long-term instance")
    check(sum(n_dets) == 0 or len(inst) > 0,
          f"{sum(n_dets)} detections gave no long-term instance")
    check(int(mem.state.num_voxels) > 0, "no voxels after 32 frames")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steady = statistics.median(flush_ms[1:])
    log("clip", f"ClipPatchDetector -> VoxelTokenMemory (Config(), "
        f"{N_FRAMES} frames): flush ms (8 frames, ViT-L ingest + ViT-H "
        f"detector) {[round(t, 3) for t in flush_ms]}, steady median "
        f"{steady:.3f}; detections per flush {n_dets}; long-term instances "
        f"{len(inst)}; {int(mem.state.num_voxels)} voxels; peak device "
        f"memory {peak:.2f} GB")
    result.update({"detector_flush_ms": flush_ms,
                   "detector_flush_steady_ms": steady,
                   "detections": list(n_dets),
                   "long_term_instances": len(inst),
                   "peak_gb": peak})
    del mem
    torch.cuda.empty_cache()

    # random-init towers give near-uniform class scores, so no patch may
    # pass 0.55: feed the same frames again with the threshold at the 99th
    # percentile of the heat they give, so that boxes reach the long-term
    # memory at the full frame size and grid
    sims = np.concatenate([
        det.embed(np.stack([o["rgb"] for o, _ in frames[i:i + BATCH]]))
        for i in range(0, N_FRAMES, BATCH)]) @ det.text_emb.T * 100.0
    p = np.exp(sims - sims.max(axis=-1, keepdims=True))
    heat = (p / p.sum(axis=-1, keepdims=True)).max(axis=-1)
    det.confidence = float(np.percentile(heat, 99))
    n_dets.clear()
    mem = VoxelTokenMemory(cfg, env, perception, detector=det)
    for obs, pose in frames:
        mem.push_frame(obs, pose)
    inst = mem.long_memory_dict
    check(len(inst) > 0 and all(o["label"] in labels and 0 <= o["loc"][0] < G
                                and 0 <= o["loc"][1] < G
                                and 0 <= o["loc"][2] < Z for o in inst),
          f"threshold {det.confidence}: {sum(n_dets)} detections, "
          f"{len(inst)} long-term instances")
    log("clip", f"heat over the 32 frames: max {heat.max():.4f}, median "
        f"{np.median(heat):.4f}; at the 99th percentile "
        f"({det.confidence:.4f}): detections per flush {n_dets}, "
        f"long-term instances {len(inst)}")
    result.update({"heat_max": float(heat.max()),
                   "p99_threshold": det.confidence,
                   "p99_detections": list(n_dets),
                   "p99_long_term_instances": len(inst)})
    del mem, perception, params, det, clip
    torch.cuda.empty_cache()
    return result


def spin_frames(cfg, seed, n):
    """n frames turning in place in the fake box world."""
    from bsc_nav_tpu_torch.env.fake import BoxScene, FakeNavEnv
    from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat

    env = FakeNavEnv(cfg, scene=BoxScene.default(), seed=seed)
    env.reset(init_state=AgentState(np.zeros(3), Quat.from_yaw(0.0)),
              build_map=True)
    frames, obs = [], env.sims.get_sensor_observations(0)
    for _ in range(n):
        frames.append(({"rgb": obs["rgb"], "depth": obs["depth"]},
                       env.agent_pose_vec()))
        obs = env.step("turn_left")
    return env, frames


def phase_clip_parity(dev, seed):
    """A small CLIP (vision head_dim 80, causal text head_dim 64) on the
    card (K3, torch._int_mm) against the CPU (plain versions)."""
    from bsc_nav_tpu_torch.config import (
        HM3D_DETECT_CLASSES, small_test_config)
    from bsc_nav_tpu_torch.models.tokenizer import HashTokenizer
    from bsc_nav_tpu_torch.agents.matchers import CLIPMatcher
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import vit
    from bsc_nav_tpu_torch.models.detector import ClipPatchDetector

    pcfg = C.CLIPConfig(embed_dim=64, image_size=56, patch_size=14,
                        vision_width=160, vision_layers=2, vision_heads=2,
                        context_length=77, vocab_size=512, text_width=128,
                        text_heads=2, text_layers=2)
    cpu_clip = C.init_params(pcfg, torch.Generator().manual_seed(seed),
                             device="cpu")
    card_clip = C.CLIP(pcfg, device=dev)
    card_clip.load_state_dict(cpu_clip.state_dict())
    tok = HashTokenizer(vocab_size=512, context_length=77)
    labels = list(HM3D_DETECT_CLASSES)
    rng = np.random.default_rng(seed)
    views = rng.integers(0, 256, size=(6, 64, 64, 3), dtype=np.uint8)
    errs = {}
    for quantize in (False, True):
        name = "int8" if quantize else "f32"
        mc, mg = (CLIPMatcher(c, pcfg, tok, quantize=quantize)
                  for c in (cpu_clip, card_clip))
        before = counts()
        pairs = [(mc._embed_views(views), mg._embed_views(views)),
                 (mc._embed_text(labels), mg._embed_text(labels)),
                 (mc.score(views, "a bed"), mg.score(views, "a bed"))]
        check(since(before)[2] > 0, "clip-parity: K3 never ran")
        err = max(float(np.abs(a - b).max()) for a, b in pairs)
        cos = min(unit_cos(a, b) for a, b in pairs[:2])
        if quantize:
            check(err <= INT8_TOL and cos >= INT8_MIN_COS,
                  f"clip-parity int8: err {err}, cosine {cos}")
        else:
            check(err <= CLIP_TOL, f"clip-parity f32: err {err}")
        errs[name] = err
        log("clip-parity", f"{name}: view/label features and scores, card "
            f"vs CPU: max err {err:.3g}, min cosine {cos:.7f} (tol "
            f"{INT8_TOL if quantize else CLIP_TOL})")

    cfg = small_test_config()
    vcfg = vit.ViTConfig(img_size=28, patch_size=14, dim=32, depth=1,
                         heads=2, num_registers=1)
    cpu_vit = vit.init_params(vcfg, torch.Generator().manual_seed(seed),
                              device="cpu")
    card_vit = vit.ViT(vcfg, device=dev)
    card_vit.load_state_dict(cpu_vit.state_dict())
    env, frames = spin_frames(cfg, seed, 12)
    dets = [ClipPatchDetector(c, pcfg, tok, labels, confidence=0.55)
            for c in (cpu_clip, card_clip)]
    # detections are compared only away from the threshold and from ties
    # between a patch's two best classes (the x100 softmax turns 1e-6 in a
    # cosine into 1e-4 in a heat value)
    sims = dets[0].embed(np.stack([o["rgb"] for o, _ in frames])) @ \
        dets[0].text_emb.T * 100.0
    p = np.exp(sims - sims.max(axis=-1, keepdims=True))
    p = np.sort(p / p.sum(axis=-1, keepdims=True), axis=-1)
    check(np.abs(p[..., -1] - 0.55).min() > 1e-4
          and (p[..., -1] - p[..., -2]).min() > 1e-4,
          "clip-parity: a heat value within 1e-4 of the threshold or a tie")
    mems = []
    for d, model, det in (("cpu", cpu_vit, dets[0]), (dev, card_vit,
                                                      dets[1])):
        perception = Perception.create(cfg, vcfg, vit_params=model,
                                       batch_size=4, device=d)
        mem = VoxelTokenMemory(cfg, env, perception, detector=det)
        for obs, pose in frames:
            mem.push_frame(obs, pose)
        mem.flush()
        mems.append(sorted(mem.long_memory_dict,
                           key=lambda o: (o["label"], o["loc"])))
    a, b = mems
    check([(o["label"], o["loc"]) for o in a]
          == [(o["label"], o["loc"]) for o in b] and len(a) > 0,
          f"clip-parity: long-term instances differ ({len(a)} vs {len(b)})")
    cerr = max(abs(x["confidence"] - y["confidence"]) for x, y in zip(a, b))
    check(cerr <= 1e-4, f"clip-parity: confidence err {cerr}")
    log("clip-parity", f"detector -> long-term memory, small_test_config, "
        f"12 frames: {len(a)} instances equal, confidence err {cerr:.3g} "
        f"(tol 1e-4)")
    errs["long_term_instances"] = len(a)
    return errs


# ---------------------------------------------------------------------------
# phase: the text query at full width
# ---------------------------------------------------------------------------

TEXT_PROMPT = "a sofa"
N_TEXT_QUERIES = 2


def toy_t5_tokenizer():
    """A small in-memory unigram model (the way tests/test_sentencepiece.py
    builds one): no spiece.model ships with the repository."""
    from bsc_nav_tpu_torch.models import sentencepiece as SP
    pieces = ([("<pad>", 0.0, SP.CONTROL), ("</s>", 0.0, SP.CONTROL),
               ("<unk>", 0.0, SP.UNKNOWN), (SP.WS, -3.0, SP.NORMAL),
               (SP.WS + "a", -1.0, SP.NORMAL),
               (SP.WS + "sofa", -1.5, SP.NORMAL)]
              + [(ch, -4.0, SP.NORMAL) for ch in "abcdefghijklmnopqrstuvwxyz"])
    return SP.SentencePieceUnigram.from_model_bytes(
        SP.serialize_model_proto(pieces))


@torch.no_grad()
def fill_zero_mods(mmdit, gen, std=0.25):
    """Seeded values in the MMDiT's zero-initialised adaLN ``mod``,
    ``final_mod`` and ``final_out`` linears: with zeros, attention never
    reaches the output and a broken kernel would pass every check."""
    def fill(p):
        w = p["w"]
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                * (std / math.sqrt(w.shape[0])))

    for blk in mmdit["blocks"]:
        fill(blk["x"]["mod"])
        fill(blk["ctx"]["mod"])
    fill(mmdit["final_mod"])
    fill(mmdit["final_out"])


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def n_params(tree) -> int:
    n = []
    tree_map(lambda t: n.append(t.numel()), tree)
    return sum(n)


def textq_weights(dev, seed):
    """Random bf16 weights at full width, from the seed, on the card."""
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import mmdit as M
    from bsc_nav_tpu_torch.models import t5 as T5
    from bsc_nav_tpu_torch.models import vae as V

    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    w = {"mmdit": M.init_params(M.SD35_MEDIUM, gen, bf, dev),
         "vae": V.init_params(V.SD3_VAE, gen, bf, dev),
         "clip_l": C.init_text_params(C.SD3_CLIP_L, gen, bf, dev),
         "clip_g": C.init_text_params(C.SD3_CLIP_G, gen, bf, dev),
         "t5": T5.init_params(T5.T5_XXL, gen, bf, dev)}
    fill_zero_mods(w["mmdit"], gen)
    return w


def make_imagination(w, t5_params, quantize, seed):
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import mmdit as M
    from bsc_nav_tpu_torch.models import t5 as T5
    from bsc_nav_tpu_torch.models import vae as V
    from bsc_nav_tpu_torch.models.imagination import DiffusionImagination
    from bsc_nav_tpu_torch.models.tokenizer import default_tokenizer

    return DiffusionImagination(
        mmdit_params=w["mmdit"], mmdit_cfg=M.SD35_MEDIUM,
        vae_params=w["vae"], vae_cfg=V.SD3_VAE,
        clip_l_params=w["clip_l"], clip_l_cfg=C.SD3_CLIP_L,
        clip_g_params=w["clip_g"], clip_g_cfg=C.SD3_CLIP_G,
        tokenizer=default_tokenizer(), t5_params=t5_params,
        t5_cfg=T5.T5_XXL, t5_tokenizer=toy_t5_tokenizer(), t5_seq_len=512,
        quantize=quantize, seed=seed)


def kernel_split(prof) -> tuple:
    """Device time (ms) of the profiled kernels by kind, and the five
    largest kernels (by summed time) among the rest."""
    split = {"K4 joint_qkv_attention": 0.0, "K1/K3 attention": 0.0,
             "GEMMs": 0.0, "convolutions (VAE)": 0.0, "rest": 0.0}
    rest = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n, ms = e.name, e.time_range.elapsed_us() / 1e3
        low = n.lower()
        if "joint_qkv" in n:
            split["K4 joint_qkv_attention"] += ms
        elif "short_attention" in n:
            split["K1/K3 attention"] += ms
        elif "conv" in low or "fprop" in low or "dgrad" in low:
            split["convolutions (VAE)"] += ms
        elif any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet")):
            split["GEMMs"] += ms
        else:
            split["rest"] += ms
            rest[n[:60]] = rest.get(n[:60], 0.0) + ms
    return split, sorted(rest.items(), key=lambda kv: -kv[1])[:5]


def phase_textq(dev, name, cfg, vcfg, world, imagination, seed):
    """VoxelTokenMemory(Config()) over the 32 frames with the imagination;
    voxel_localized(TEXT_PROMPT) N_TEXT_QUERIES times, then once under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import mmdit as M
    from bsc_nav_tpu_torch.models import t5 as T5
    from bsc_nav_tpu_torch.models import vit

    env, frames, _ = world
    torch.cuda.reset_peak_memory_stats()
    params = vit.init_params(
        vcfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    perception = Perception.create(cfg, vit_params=params, batch_size=BATCH,
                                   device=dev)
    mem = VoxelTokenMemory(cfg, env, perception, imagination=imagination)
    for obs, pose in frames:
        mem.push_frame(obs, pose)
    mem.flush()
    torch.cuda.synchronize()
    check(int(mem.state.num_voxels) > 0, f"{name}: no voxels")

    mcfg = M.SD35_MEDIUM
    k4_per_query = imagination.num_steps * (
        mcfg.depth + len(mcfg.dual_attention_layers))
    k3_per_query = 2 * (C.SD3_CLIP_L.text_layers + C.SD3_CLIP_G.text_layers)
    query_ms = []
    for i in range(N_TEXT_QUERIES):
        before = counts()
        t0 = time.perf_counter()
        best, pos, sims = mem.voxel_localized(TEXT_PROMPT, K=cfg.query.top_k)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        d = since(before)
        check(d == (vcfg.depth, 1, k3_per_query, k4_per_query),
              f"{name} query {i}: K1-K4 +{d} (want +{vcfg.depth}, +1, "
              f"+{k3_per_query}, +{k4_per_query})")
        check(k4_per_query == 1036, f"{k4_per_query} K4 launches per query")
        check(len(pos) > 0 and bool(np.isfinite(sims).all())
              and bool((np.abs(sims) <= 1 + 1e-5).all())
              and bool((np.diff(sims) <= 0).all()),
              f"{name} query {i}: bad top-K {sims[:5]}")
        imgs = mem.last_imagined
        check(imgs.dtype == torch.uint8
              and tuple(imgs.shape) == (imagination.num_images, 512, 512, 3),
              f"{name}: images {imgs.dtype} {tuple(imgs.shape)}")
        check(float(imgs.float().std()) > 0, f"{name}: flat images")
    peak = torch.cuda.max_memory_allocated() / 1e9
    img_stats = (float(imgs.float().mean()), float(imgs.float().std()))

    # T5 alone (cond + uncond prompts), CUDA events: the profiler's kernel
    # names cannot tell its GEMMs from the MMDiT's
    t5_ids = imagination.prep_inputs(TEXT_PROMPT)[2::]
    t5_ms = cuda_ms(lambda: [T5.encode(imagination.t5_params, t, T5.T5_XXL)
                             for t in t5_ids], reps=3, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mem.voxel_localized(TEXT_PROMPT, K=cfg.query.top_k)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    split, top_rest = kernel_split(prof)
    busy = sum(split.values())
    log(name, f"VoxelTokenMemory(Config()) over {N_FRAMES} frames "
        f"({int(mem.state.num_voxels)} voxels): voxel_localized("
        f"{TEXT_PROMPT!r}) ms {[round(t, 1) for t in query_ms]} (host clock, "
        f"3 images 512^2, 28 steps, CFG {imagination.guidance_scale}, top-"
        f"{cfg.query.top_k} of {len(pos)}); launches per query K1 "
        f"{vcfg.depth}, K2 1, K3 {k3_per_query}, K4 {k4_per_query}; images "
        f"mean {img_stats[0]:.1f} std {img_stats[1]:.1f}; peak device "
        f"memory {peak:.2f} GB")
    if busy == 0:
        log(name, "torch.profiler saw no device kernels: split not measured")
    else:
        log(name, "profiled query, device time by kind (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
            + f"; kernels busy {busy:.1f} of {profiled_ms:.1f} ms host clock "
            f"(idle share {1 - busy / profiled_ms:.3f}); largest of the rest: "
            + ", ".join(f"{k} {v:.1f}" for k, v in top_rest)
            + f"; T5-XXL encode of the two prompts alone {t5_ms:.1f} ms "
            f"(CUDA events)")
    result = {"query_ms": query_ms, "peak_gb": peak,
              "k4_per_query": k4_per_query, "k3_per_query": k3_per_query,
              "profile_ms": split, "profiled_query_ms": profiled_ms,
              "profile_top_rest": top_rest, "t5_encode_ms": t5_ms,
              "num_voxels": int(mem.state.num_voxels)}
    del mem, perception, params
    torch.cuda.empty_cache()
    return result


def phase_textq_all(dev, cfg, vcfg, world, seed):
    """textq bf16, then textq int8 (MMDiT W8A8, T5 quantized on the host)
    from the same random weights."""
    from bsc_nav_tpu_torch.models import t5 as T5
    from bsc_nav_tpu_torch.models.weights import t5_from_jax_params

    t0 = time.perf_counter()
    w = textq_weights(dev, seed)
    torch.cuda.synchronize()
    log("textq bf16", f"random bf16 weights on the card in "
        f"{time.perf_counter() - t0:.1f} s: SD3.5-medium MMDiT "
        f"{n_params(w['mmdit']) / 1e9:.3f} G, T5-XXL "
        f"{n_params(w['t5']) / 1e9:.3f} G, CLIP-L "
        f"{sum(p.numel() for p in w['clip_l'].parameters()) / 1e9:.3f} G, "
        f"CLIP-G {sum(p.numel() for p in w['clip_g'].parameters()) / 1e9:.3f}"
        f" G, VAE decoder {n_params(w['vae']) / 1e9:.3f} G parameters")
    out = {"bf16": phase_textq(dev, "textq bf16", cfg, vcfg, world,
                               make_imagination(w, w["t5"], False, seed),
                               seed)}

    t0 = time.perf_counter()
    host = tree_map(lambda t: t.float().cpu().numpy(), w.pop("t5"))
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    t5_q = t5_from_jax_params(T5.quantize_params_host(host), T5.T5_XXL,
                              dtype=torch.bfloat16, device=dev)
    del host
    torch.cuda.synchronize()
    log("textq int8", f"T5-XXL to the host {t1 - t0:.1f} s, "
        f"quantize_params_host + upload {time.perf_counter() - t1:.1f} s")
    out["int8"] = phase_textq(dev, "textq int8", cfg, vcfg, world,
                              make_imagination(w, t5_q, True, seed), seed)
    del w, t5_q
    torch.cuda.empty_cache()
    return out


def phase_textq_parity(dev, seed):
    """A small imagination on the card (K4, K3, cuDNN) against the CPU
    (plain versions), the same weights and injected noise."""
    import dataclasses

    from bsc_nav_tpu_torch.config import small_test_config
    from bsc_nav_tpu_torch.memory import pipeline
    from bsc_nav_tpu_torch.memory.ingest import points_per_frame
    from bsc_nav_tpu_torch.memory.store import init_store
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import mmdit as M
    from bsc_nav_tpu_torch.models import t5 as T5
    from bsc_nav_tpu_torch.models import vae as V
    from bsc_nav_tpu_torch.models import vit
    from bsc_nav_tpu_torch.models.imagination import DiffusionImagination
    from bsc_nav_tpu_torch.models.tokenizer import HashTokenizer

    cfg = small_test_config()
    mcfg = M.MMDiTConfig(input_size=8, patch_size=2, in_channels=4, dim=128,
                         depth=2, heads=2, context_dim=128, pooled_dim=16,
                         dual_attention_layers=(0,))
    lcfg = C.CLIPConfig(embed_dim=6, text_width=32, text_heads=2,
                        text_layers=2, context_length=16, vocab_size=512,
                        quick_gelu=True)
    gcfg = C.CLIPConfig(embed_dim=10, text_width=64, text_heads=4,
                        text_layers=3, context_length=16, vocab_size=512)
    t5cfg = T5.T5Config(vocab_size=256, dim=128, d_kv=16, heads=4, d_ff=256,
                        layers=2)
    vaecfg = dataclasses.replace(V.VAE_TEST, blocks_per_stage=1)
    vcfg = vit.ViTConfig(img_size=28, patch_size=14, dim=32, depth=2,
                         heads=2, num_registers=1)
    gen = torch.Generator().manual_seed(seed)
    mm = M.init_params(mcfg, gen, device="cpu")
    fill_zero_mods(mm, gen)
    last = mm["blocks"][-1]["ctx"]          # a context_pre_only last block
    last["mod"] = {k: v[..., :2 * mcfg.dim].contiguous()
                   for k, v in last["mod"].items()}
    cpu = {"mmdit": mm, "vae": V.init_params(vaecfg, gen, device="cpu"),
           "t5": T5.init_params(t5cfg, gen, device="cpu"),
           "clip_l": C.init_text_params(lcfg, gen, device="cpu"),
           "clip_g": C.init_text_params(gcfg, gen, device="cpu"),
           "vit": vit.init_params(vcfg, gen, device="cpu")}
    card = {k: tree_map(lambda t: t.to(dev), cpu[k])
            for k in ("mmdit", "vae", "t5")}
    for k, c in (("clip_l", lcfg), ("clip_g", gcfg)):
        card[k] = C.TextTower(c, torch.float32, dev)
        card[k].load_state_dict(cpu[k].state_dict())
    card["vit"] = vit.ViT(vcfg, device=dev)
    card["vit"].load_state_dict(cpu["vit"].state_dict())

    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.normal(size=(2, 8, 8, 4)).astype(np.float32))
    lat0 = torch.from_numpy(rng.normal(size=(4, 8, 8, 4)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.1, 1, size=4).astype(np.float32))
    B, H, W = 8, cfg.sensor.height, cfg.sensor.width
    P = points_per_frame(cfg)
    frames = [rng.integers(0, 255, size=(B, H, W, 3), dtype=np.uint8),
              rng.uniform(0.3, 4.0, size=(B, H, W)).astype(np.float32),
              np.concatenate([rng.uniform(-1, 1, size=(B, 3)),
                              rng.normal(size=(B, 4))], 1).astype(np.float32),
              rng.integers(0, H * W, size=(B, P)),
              rng.integers(0, cfg.memory.cache_size, size=B * P)]

    out = {}
    for d, w in (("cpu", cpu), (dev, card)):
        im = DiffusionImagination(
            mmdit_params=w["mmdit"], mmdit_cfg=mcfg, vae_params=w["vae"],
            vae_cfg=vaecfg, clip_l_params=w["clip_l"], clip_l_cfg=lcfg,
            clip_g_params=w["clip_g"], clip_g_cfg=gcfg,
            tokenizer=HashTokenizer(512, 16), num_images=2, num_steps=3,
            guidance_scale=4.0, t5_params=w["t5"], t5_cfg=t5cfg,
            t5_tokenizer=toy_t5_tokenizer(), t5_seq_len=8, seed=seed)
        inputs = im.prep_inputs(TEXT_PROMPT)
        ctx, pool = im.encode_conditioning(inputs[0], inputs[2])
        vel = M.forward(w["mmdit"], lat0.to(d), t.to(d),
                        ctx.expand(4, -1, -1), pool.expand(4, -1), mcfg)
        ctx_u, pool_u = im.encode_conditioning(inputs[1], inputs[3])
        lat = M.sample(w["mmdit"], ctx.expand(2, -1, -1),
                       pool.expand(2, -1), mcfg, num_steps=3,
                       guidance_scale=4.0,
                       context_uncond=ctx_u.expand(2, -1, -1),
                       pooled_uncond=pool_u.expand(2, -1), noise=noise.to(d))
        ts = [torch.from_numpy(a).to(d) for a in frames]
        (state, _), _ = pipeline.make_build_step(cfg, vcfg)(
            (init_store(cfg.memory, device=d), None), w["vit"], *ts[:3],
            pix=ts[3], repl_idx=ts[4])
        before = counts()
        pos, sc, imgs = pipeline.make_text_query_step(cfg, vcfg, im)(
            state, w["vit"], *inputs, noise=noise.to(d), top_k=16)
        out[str(d)] = {"vel": vel.cpu().numpy(), "lat": lat.cpu().numpy(),
                       "pos": pos.cpu().numpy(), "sc": sc.cpu().numpy(),
                       "imgs": imgs.cpu().numpy().astype(int),
                       "launches": since(before)}
    a, b = out["cpu"], out[str(dev)]
    check(a["launches"] == (0, 0, 0, 0) and b["launches"][3] > 0
          and b["launches"][2] > 0, f"textq-parity launches {b['launches']}")
    v_err = float(np.abs(a["vel"] - b["vel"]).max())
    l_err = float(np.abs(a["lat"] - b["lat"]).max())
    i_err = int(np.abs(a["imgs"] - b["imgs"]).max())
    check(float(np.abs(a["vel"]).max()) > 0.5, "textq-parity: zero velocity")
    check(v_err <= TEXTQ_V_TOL, f"textq-parity: velocity err {v_err}")
    check(l_err <= TEXTQ_LAT_TOL, f"textq-parity: latent err {l_err}")
    check(i_err <= 1, f"textq-parity: images differ by {i_err} levels")
    check(bool(np.isfinite(a["sc"]).all()), "textq-parity: -inf in top-K")
    s_err = float(np.abs(a["sc"] - b["sc"]).max())
    check(s_err <= PARITY_TOL, f"textq-parity: score err {s_err}")
    kth = a["sc"].min()
    above = [set(map(tuple, o["pos"][o["sc"] > kth + PARITY_TOL]))
             for o in (a, b)]
    check(above[0] == above[1], "textq-parity: top-K sets differ")
    log("textq-parity", f"MMDiT 2 x 128 (2 heads of 64, dual block 0, "
        f"context_pre_only last block), tiny T5 / CLIP-L/G / VAE / ViT: "
        f"velocity err {v_err:.3g} (tol {TEXTQ_V_TOL}), latents after 3 CFG "
        f"steps {l_err:.3g} (tol {TEXTQ_LAT_TOL}), images within {i_err} "
        f"level(s), top-16 equal (score err {s_err:.3g}); card launches "
        f"K1-K4 {b['launches']}")
    return {"velocity_err": v_err, "latent_err": l_err, "image_levels": i_err,
            "score_err": s_err, "card_launches": list(b["launches"])}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    from bsc_nav_tpu_torch.config import Config
    from bsc_nav_tpu_torch.models.vit import CONFIGS
    from bsc_nav_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.kernels()
    log("build", f"{lib.name} from {[p.name for p in _build.sources()]} "
        f"(nvcc {' '.join(_build.NVCC_FLAGS[:2])}) in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cases = phase_kernels(dev, gen)

    cfg = Config()
    vcfg = CONFIGS[cfg.models.encoder]
    check((vcfg.dim, vcfg.depth, vcfg.heads) == (1024, 24, 16),
          "the default encoder is not ViT-L")
    t0 = time.perf_counter()
    world = render_world(cfg, args.seed)
    log("slice", f"rendered {N_FRAMES} frames + {N_QUERIES}x{QUERY_IMAGES} "
        f"query views at {cfg.sensor.width}x{cfg.sensor.height} in "
        f"{time.perf_counter() - t0:.1f} s")
    # each main path runs with the counts set to 0 just before it
    reset_counts()
    slices = [phase_slice(dev, dt, cfg, vcfg, world, args.seed)
              for dt in (torch.float32, torch.bfloat16)]
    spine = counts()
    log("slice", f"launches on the memory spine: K1 {spine[0]}, K2 "
        f"{spine[1]}, K3 {spine[2]}, K4 {spine[3]}")
    check(spine[0] > 0 and spine[1] > 0 and spine[2] == spine[3] == 0,
          f"memory spine launches K1-K4 = {spine}")
    parity_err = phase_parity(dev, args.seed)

    reset_counts()
    clip = phase_clip(dev, cfg, vcfg, world, args.seed)
    clip_path = counts()
    log("clip", f"launches on the CLIP path (DINOv2 ingest included): K1 "
        f"{clip_path[0]}, K2 {clip_path[1]}, K3 {clip_path[2]}, K4 "
        f"{clip_path[3]}")
    check(clip_path[2] > 0 and clip_path[3] == 0,
          f"CLIP path launches K1-K4 = {clip_path}")
    clip_parity = phase_clip_parity(dev, args.seed)

    reset_counts()
    textq = phase_textq_all(dev, cfg, vcfg, world, args.seed)
    textq_path = counts()
    log("textq", f"launches on the text-query path (bf16 and int8, DINOv2 "
        f"ingest included): K1 {textq_path[0]}, K2 {textq_path[1]}, K3 "
        f"{textq_path[2]}, K4 {textq_path[3]}")
    check(min(textq_path) > 0, f"text-query launches K1-K4 = {textq_path}")
    textq_parity = phase_textq_parity(dev, args.seed)
    stray = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "bsc_nav_tpu"))
    check(not stray, f"imported {stray[:5]}")

    paths = {"spine": spine, "clip": clip_path, "textq": textq_path}

    def main_case(kernel, dtype="float32", **match):
        match = match or {"B": 8}
        return next(c for c in cases if c["kernel"] == kernel
                    and c["dtype"] == dtype
                    and all(c.get(k, v) == v for k, v in match.items()))

    def entry(name, source, replaces, i, case):
        by_path = {p: n[i] for p, n in paths.items()}
        return {"name": name, "route": "cuda",
                "source": f"bsc_nav_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "cases": [c for c in cases if c["kernel"] == case["kernel"]]}

    print(json.dumps({"kernels": [
        entry("short_attention_qkv", "short_attention_qkv.cu",
              "bsc_nav_tpu/ops/flash_attention.py:422", 0, main_case("K1")),
        entry("max_cosine_per_voxel", "max_cosine.cu",
              "bsc_nav_tpu/ops/similarity.py:56", 1, main_case("K2")),
        entry("short_attention", "short_attention.cu",
              "bsc_nav_tpu/ops/flash_attention.py:364", 2,
              main_case("K3", case="vision")),
        entry("joint_qkv_attention", "joint_qkv_attention.cu",
              "bsc_nav_tpu/ops/flash_attention.py:550", 3,
              main_case("K4", "bfloat16", case="joint")),
    ], "slices": slices, "slice_parity_max_err": parity_err, "clip": clip,
        "clip_parity": clip_parity, "textq": textq,
        "textq_parity": textq_parity}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
