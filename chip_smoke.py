#!/usr/bin/env python3
"""Drive the PyTorch port's memory spine and CLIP stack once on one NVIDIA GPU
and check them.

    python3 chip_smoke.py [--seed N]

Phases, one line each (any failed check raises, so the script exits
non-zero):

  build         compile bsc_nav_tpu_torch/csrc/*.cu with nvcc for sm_90a
  kernels       K1 short_attention_qkv, K2 max_cosine_per_voxel and K3
                short_attention against their plain PyTorch versions on the
                card, at the main paths' shapes, with both times (CUDA
                events, median of 20 runs); K1 also at the CLIP vision
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
PARITY_TOL = 1e-4       # top-K scores, f32 slice on card vs CPU


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
    """Launch counts of (K1, K2, K3)."""
    from bsc_nav_tpu_torch.ops import flash_attention, similarity
    return (flash_attention.short_attention_qkv.launches,
            similarity.max_cosine_per_voxel.launches,
            flash_attention.short_attention.launches)


def since(before):
    return tuple(a - b for a, b in zip(counts(), before))


def reset_counts() -> None:
    from bsc_nav_tpu_torch.ops import flash_attention, similarity
    flash_attention.short_attention_qkv.launches = 0
    similarity.max_cosine_per_voxel.launches = 0
    flash_attention.short_attention.launches = 0


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each element of x."""
    mag = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def unit_cos(a: np.ndarray, b: np.ndarray) -> float:
    return float((a * b).sum(-1).min())


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
            tol = K1_TOL[dtype]
            log("kernels", f"K1 short_attention_qkv B={B} S={S} {H}x{hd} "
                f"{str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol}) "
                f"kernel {ms:.4f} ms plain {plain:.4f} ms")
            check(err <= tol, f"K1 B={B} {dtype}: err {err} > {tol}")
            cases.append({"kernel": "K1", "B": B, "S": S, "heads": H,
                          "head_dim": hd, "dtype": str(dtype)[6:],
                          "max_abs_err": err, "tol": tol, "ms": ms,
                          "plain_ms": plain})
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
        nbytes = f.numel() * f.element_size()
        log("kernels", f"K2 max_cosine_per_voxel V1={V1} K={K} D={D} "
            f"{str(dtype)[6:]} store {nbytes / 1e9:.2f} GB: max_abs_err "
            f"{err:.3g} (tol {K2_TOL} abs + 1e-5 rel) kernel {ms:.4f} ms "
            f"plain {plain:.4f} ms")
        cases.append({"kernel": "K2", "V1": V1, "K": K, "D": D,
                      "dtype": str(dtype)[6:], "store_bytes": nbytes,
                      "max_abs_err": err, "tol": K2_TOL, "ms": ms,
                      "plain_ms": plain})
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
            log("kernels", f"K3 short_attention {case} B={B} {H}x{hd} "
                f"Sq={Sq} Sk={Sk} causal={causal} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g} (tol {K3_TOL}"
                f"{' + 1 bf16 ulp' if dtype == torch.bfloat16 else ''}) "
                f"kernel {ms:.4f} ms plain {plain:.4f} ms")
            cases.append({"kernel": "K3", "case": case, "B": B, "heads": H,
                          "Sq": Sq, "Sk": Sk, "head_dim": hd,
                          "causal": causal, "dtype": str(dtype)[6:],
                          "max_abs_err": err, "tol": K3_TOL, "ms": ms,
                          "plain_ms": plain})
            del q, k, v, got, want, diff

    # K1 at the CLIP vision shape, from a fused qkv: the JAX dispatch sends
    # this shape to K3 (head_dim 80), K1 is timed beside it for comparison
    for dtype in (torch.float32, torch.bfloat16):
        B, S, H, hd = 12, 257, 16, 80
        qkv = torch.randn(B, S, 3 * H * hd, generator=gen, device=dev
                          ).to(dtype)
        err = (fa.short_attention_qkv(qkv, H).float()
               - fa.short_attention_qkv_reference(qkv, H).float()
               ).abs().max().item()
        check(err <= K1_TOL[dtype], f"K1 vision shape {dtype}: err {err}")
        ms = cuda_ms(lambda: fa.short_attention_qkv(qkv, H))
        plain = cuda_ms(lambda: fa.short_attention_qkv_reference(qkv, H))
        log("kernels", f"K1 short_attention_qkv at the CLIP vision shape "
            f"B={B} S={S} {H}x{hd} {str(dtype)[6:]}: max_abs_err {err:.3g} "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms")
        cases.append({"kernel": "K1", "case": "clip-vision-shape", "B": B,
                      "S": S, "heads": H, "head_dim": hd,
                      "dtype": str(dtype)[6:], "max_abs_err": err,
                      "tol": K1_TOL[dtype], "ms": ms, "plain_ms": plain})
        del qkv
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phase: slice at the full default config
# ---------------------------------------------------------------------------

def render_world(cfg, seed):
    """32 frames turning in place, and 3 query groups of 3 close-up views
    of the scene's first three boxes, from the fake environment."""
    from bsc_nav_tpu.env.pathfinding import AgentState, Quat

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
        check(d == (vcfg.depth, 0, 0),
              f"flush {i}: K1, K2, K3 +{d} (want +{vcfg.depth}, +0, +0)")
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
        check(d == (vcfg.depth, 1, 0),
              f"query {i}: K1, K2, K3 +{d} (want +{vcfg.depth}, +1, +0)")
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
    from bsc_nav_tpu.config import small_test_config
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
    cpu_model = vit.init_params(vcfg, torch.Generator().manual_seed(seed))
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
    from bsc_nav_tpu.config import HM3D_DETECT_CLASSES
    from bsc_nav_tpu.models.tokenizer import default_tokenizer
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
        check(d == (0, 0, SCORE_REPS * L_v + L_t),
              f"clip {name} score: K1, K2, K3 +{d}")
        before = counts()
        s_img = m.score(views, queries[0][0])
        best = m.best("bed", labels)
        d = since(before)
        check(d == (0, 0, 2 * L_v + 2 * L_t),
              f"clip {name} image score + best: K1, K2, K3 +{d}")
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
        check(d == (vcfg.depth, 0, L_v - 1),
              f"detector flush {i}: K1, K2, K3 +{d} (want +{vcfg.depth}, "
              f"+0, +{L_v - 1})")
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
    from bsc_nav_tpu.env.fake import BoxScene, FakeNavEnv
    from bsc_nav_tpu.env.pathfinding import AgentState, Quat

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
    from bsc_nav_tpu.config import HM3D_DETECT_CLASSES, small_test_config
    from bsc_nav_tpu.models.tokenizer import HashTokenizer
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
    cpu_clip = C.init_params(pcfg, torch.Generator().manual_seed(seed))
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
    cpu_vit = vit.init_params(vcfg, torch.Generator().manual_seed(seed))
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

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    from bsc_nav_tpu.config import Config
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
        f"{spine[1]}, K3 {spine[2]}")
    check(spine[0] > 0 and spine[1] > 0 and spine[2] == 0,
          f"memory spine launches K1, K2, K3 = {spine}")
    parity_err = phase_parity(dev, args.seed)

    reset_counts()
    clip = phase_clip(dev, cfg, vcfg, world, args.seed)
    clip_path = counts()
    log("clip", f"launches on the CLIP path (DINOv2 ingest included): K1 "
        f"{clip_path[0]}, K2 {clip_path[1]}, K3 {clip_path[2]}")
    check(clip_path[2] > 0, f"CLIP path launches K1, K2, K3 = {clip_path}")
    clip_parity = phase_clip_parity(dev, args.seed)
    check("jax" not in sys.modules, "jax was imported")

    def main_case(kernel, **match):
        match = match or {"B": 8}
        return next(c for c in cases if c["kernel"] == kernel
                    and c["dtype"] == "float32"
                    and all(c.get(k, v) == v for k, v in match.items()))

    def entry(name, source, replaces, i, case):
        return {"name": name, "route": "cuda",
                "source": f"bsc_nav_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": spine[i] + clip_path[i],
                "launches_by_path": {"spine": spine[i], "clip": clip_path[i]},
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"],
                "cases": [c for c in cases if c["kernel"] == case["kernel"]]}

    print(json.dumps({"kernels": [
        entry("short_attention_qkv", "short_attention_qkv.cu",
              "bsc_nav_tpu/ops/flash_attention.py:422", 0, main_case("K1")),
        entry("max_cosine_per_voxel", "max_cosine.cu",
              "bsc_nav_tpu/ops/similarity.py:56", 1, main_case("K2")),
        entry("short_attention", "short_attention.cu",
              "bsc_nav_tpu/ops/flash_attention.py:364", 2,
              main_case("K3", case="vision")),
    ], "slices": slices, "slice_parity_max_err": parity_err, "clip": clip,
        "clip_parity": clip_parity}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
