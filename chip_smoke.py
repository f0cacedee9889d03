#!/usr/bin/env python3
"""Drive the PyTorch port's memory spine, CLIP stack, YOLO-World feed, text
queries and robots once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --kernels K2,K4,K5   # those kernels' cases alone

Phases, one line each (any failed check raises, so the script exits
non-zero):

  build         compile bsc_nav_tpu_torch/csrc/*.cu with nvcc for sm_90a,
                one nvcc per source, all started together
  kernels       K1-K8 and K2b (K2's Q-query scan) against their plain
                PyTorch versions on the card, at
                the main paths' shapes (K2 on f32 and bf16 rows; K2b at
                Q 1, 3, 16 on f32, bf16 and int8 rows and at Q 16 on a
                store with the spine's share of live voxels, beside the
                GEMM composition: a single query on int8 rows is K2b at
                Q 1; its bound at the card's rate for the products' type,
                the CUDA cores' f32 FMA time beside it; the kernel each
                launch took -- max_cosine_mma_kernel on the tensor cores
                for bf16 and int8 rows, max_cosine_batch_kernel for f32 --
                and ptxas's registers and spills of the tensor-core
                instances), with
                both times (CUDA events, median
                of 20 runs), the bound reckoned from each case's bytes and
                operations (f32 products at a third of the TF32 rate, three
                TF32 products each), and one PyTorch call computing the same
                function where one exists (SDPA for K1, K3, K5 and K6,
                F.layer_norm for K7, cuDNN for K8; for K4, as context,
                SDPA on the already-normalised q/k/v), the TFLOP/s reached
                and the bound over the kernel's time, the device time alone
                from a CUDA graph replay (and the library call's), for K4,
                K5, K6 and K8 the kernel each launch took (f32: the three-pass
                TF32 tiles; bf16: attention_tma_kernel for K4 and at
                head_dim 64, conv3x3_s1_mma_kernel): K1 at
                ViT-L's S 261, K3 at the CLIP towers' shapes, K4 at
                SD3.5-medium's joint and self-attention at 512^2 and its
                self-attention at 1024^2 (S 4096, checked on one batch
                row), K5 at SD3-medium's joint attention and DINOv2 at
                518^2, K6 at SD3.5-medium's joint attention at 1024^2 and
                causal, K7 at ViT-L's token grids (dispatched nowhere, as
                in the JAX package), K8 at the 13 shapes of YOLOv8x-
                worldv2's 3x3 stride-1 convs at 640^2 (76 a forward; and
                40^2 x 640 -> 640, on no path), with the sum over one
                forward; the device kernels SDPA runs in f32 at K1's and
                K3's shapes and in bf16 at K5's and K6's main shapes, from
                the profiler; for K4 also its qk-norm pre-pass alone
                against its plain version and by graph, and "pre-pass +
                SDPA" on its rows for context
  slice f32     the full default Config() -- 680x680 RGB-D, 1000^2 x 200
                grid, 131,080 slots x 10 tokens x 1024 -- through
                Perception / VoxelTokenMemory with a random-init DINOv2
                ViT-L/14-reg: 32 frames (4 flushes of 8), then 3 image
                queries of 3 images (one with a region radius); launch
                counts, store and top-K checks, times per flush and query;
                one more query, whose K1 launches must all be the TF32
                tile (attention_tf32_kernel)
  slice bf16    the same with bf16 weights, compute and store (K1 on the
                wgmma tile)
  batch         after each slice, on its store: voxel_localized_batch for
                the robot's sweep (one prompt at radii 30/40/50 around the
                first query's best voxel), 16 distinct 3-image prompts and
                a Q 17 call (two K2b launches); each query's top-K against
                its own voxel_localized call (uncounted), K1 +depth per
                distinct prompt, K2b +ceil(Q/16); batched against single
                times
  int8          after the f32 slice: the 32 frames into an int8 store with
                the same encoder (equal, byte for byte and to the bit, to
                quantize_store of the f32 store over the live rows), the 3
                queries on K2b at Q 1, the int8 scan within the f32 dot
                bound of its plain version, the top-K overlap with the f32
                store
  persist       save_npz / load_npz of an int8 store of 653,780 rows x
                1024 (0.67 GB of codes) and of the 32-frame int8 store:
                every field array-equal, the same top-K (uncounted: the
                path launches no kernel); save / load s
  int8 encoder  Perception with encoder_int8 (ViT-L block matmuls on
                linear_q8): a flush of 8 frames and a query, K1 launches
                as in f32, every qkv/proj/fc1/fc2 call on linear_q8; with
                layer scales 1, the pooled token on the card against the
                same int8 encoder on the CPU (2e-3 of max |value|, cos
                0.9999), which the f32 encoder's pool must miss
  forget        forgetting_pass on the spine's f32, bf16 and int8 stores at
                full capacity (131,080 slots, in place, twice each) and on
                a store of 124,518 live voxels: ms, voxels and rows before
                and after; no voxel emptied, rows past a count zero-norm
  surprise      the default Config() with replacement="surprise": the 32
                frames into an f32 store (mean-field gate), frames 0-7
                again mean-field and 8-15 again in exact mode, each flush
                beside the dist policy's (slice f32), the share of valid
                points gated out; feat_obs sums to the valid points, no
                count past K; 3 image queries (K1, K2 counted); then one
                batch's ingest alone under each policy, and the neighbour
                norm's FMA chain alone
  segments      VoxelTokenMemory(segmented=True, max_device_segments=1) at
                Config()'s width and K, voxel_capacity cut to 4,096: the 32
                frames rotate into int8 segments, one on the card, the rest
                spilled to pinned host memory; their positions against the
                plain f32 store's; 3 image queries and a 3-radius batch (K2
                on the active segment, K2b at Q 1 on each frozen one).
                Then at full capacity (124,518 live voxels, random rows):
                the rotation, a query on the device segment, the spill's
                D2H and the stream back (GB/s, pinned and pageable), a
                query on the spilled segment, its scan against the plain
                version on the host rows
  explore       exploring_create_memory (random_move_num 3) and
                explore_entire_space (max_iterations 2) on FakeNavEnv at
                Config(): steps, flushes, s
  robot-parity  the drivers' fake world (drivers/setup.build_world: 64x64
                frames, a tiny ViT) on the CPU and on the card in one
                process, the same encoder weights and build draws: objnav
                through drivers.common.run_episodes, one episode on the
                long-term memory path (actions, nav_log and CSV row equal)
                and one on the working-memory path (queries within
                ROBOT_PARITY_TOL; a top-K decision within it is reported
                with its margin)
  segments-parity  small_test_config(): surprise stores in both modes, the
                forgetting pass on them and a segmented store's merged
                top-16, the card against the CPU on the same frames and
                draws
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
                gives; K3 in every CLIP layer, K1 never from a CLIP call;
                one more score per matcher and the detector's embedding of
                8 frames, whose K3 launches must all be the TF32 tile (the
                towers run f32 activations)
  clip-parity   a small CLIP keeping head_dim 80 (vision) and a causal
                head_dim 64 text tower: embeddings and scores, f32 and
                int8, on the card against the CPU, and the detector's
                long-term instances over small_test_config() frames equal
  yolo          YOLOv8x-worldv2 at 640^2 (random f32 weights, 20 seeded
                class embeddings, logit_bias set from the seed so that a
                median frame has 6 candidates over 0.55) as the
                YoloWorldDetector of VoxelTokenMemory(Config()) over the
                32 frames (4 flushes of 8, beside the ViT-L ingest), f32
                and with the neck quantized (int8, torch._int_mm): 76 and
                36 K8 launches per flush; flush and detector ms, frames/s,
                instances, forward + decode and NMS times; first the
                forward with K8 against its plain version on the card
                (YOLO_FWD_TOL), and cuDNN's f32 route with the process's
                TF32 flag on
  yolo-parity   a reduced YOLO-World (depth 1/3, width 0.5, 160^2) on the
                card against the CPU: the device feed's instances equal
  textq bf16    the text query at full width: SD3.5-medium (24 blocks x
                1536, dual attention in blocks 0-12), the SD3 CLIP-L/G text
                towers, the T5-XXL encoder at 512 tokens and the SD3 VAE
                decoder, random bf16 weights from the seed, 3 images of
                512^2, 28 steps, CFG 7.0, inside VoxelTokenMemory(Config())
                over the 32 frames: voxel_localized("a sofa") twice, then
                once under torch.profiler; 1,036 K4 launches per query,
                all on attention_tma_kernel
  textq sd3-medium  the same with SD3-medium (no qk-norm, no dual
                attention): the composed joint attention, 672 K5 launches
                per query (all on attention_tma_kernel) and no K4; each
                text query prints its host-clock times and its attention
                kernels' share of the profiled device time
  textq sd35-1024  SD3.5-medium at its published 1024^2 (a 4685-token
                joint sequence): 672 K6 and 364 K4 (the dual
                self-attention at 4096 tokens) per query, all on
                attention_tma_kernel;
                one timed and one profiled call
  textq int8    SD3.5-medium at 512^2 with the MMDiT token matmuls in W8A8
                and T5-XXL quantized on the host (quantize_params_host), the
                default diffusion_int8=True; one timed and one profiled call
  textq-parity  a small imagination (MMDiT head_dim 64 on K4's route, a
                dual block, a context_pre_only last block; tiny T5, CLIP
                towers, VAE and ViT) on the card against the CPU with the
                same injected noise: velocity, latents, images within 1
                level, equal top-K; then two small MMDiTs on the composed
                route, one without qk-norm (K5) and one past 4096 joint
                tokens with logits past 4e9 bytes (K6): velocity, latents
  robot         the robots at full width on the text-query phases' bf16
                weights: Config() with FakeBenchmarkEnv over BoxScene at
                680x680, Perception (bf16 compute, random ViT-L) over the
                f32 store, CLIPMatcher (MetaCLIP ViT-H/14, int8 towers) and
                ClipPatchDetector, DiffusionImagination SD3.5-medium 512^2
                bf16, the drivers' mock LLM with a scripted judge: the
                memory built as ensure_memory_fake builds it (3
                waypoints), then objnav (the stage-2 text query prefetched
                while stage 1 walks, then consumed), imagenav and vlnce
                episodes: seconds, steps, flushes, queries by stage, the
                host renderer's share; K1, K2, K3, K4 and K2b launched,
                none of K5-K8

Each main path runs with the launch counts set to 0 just before it and
read just after.  The last two lines are a JSON object of the kernels'
launch counts, errors and times, and {"ok": true, "device": {...}}.
Without CUDA it exits 1 and prints no result.  JAX is never imported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES, BATCH, N_QUERIES, QUERY_IMAGES = 32, 8, 3, 3
N_VIEWS, SCORE_REPS = 12, 4     # a 360-degree turn at 30 degrees a step
K1_TOL = 2e-5           # f32 abs; bf16: see BF16_ATTN_TOL
K3_TOL = 2e-5           # f32 abs (K3, K5, K6); bf16: see BF16_ATTN_TOL
CLIP_TOL = 1e-4         # unit features and scores, f32 CLIP on card vs CPU
# int8 towers, card vs CPU: an activation within ~1e-6 of a rounding
# boundary may take the neighbouring code on one side; one flip moves a
# unit feature by up to a few 1e-3 (tests/test_torch_clip.py INT8_TOL)
INT8_TOL, INT8_MIN_COS = 1e-2, 0.9995
K2_TOL = 2e-5           # abs, beside 1e-5 rel (zero-norm rows / 1e-12)
# K2 on int8 rows and its Q-query scan are held to the f32 dot bound of
# tests/test_torch_similarity.py (k2_bound).  A batched query on a bf16
# store rounds its query to bf16 where the single query keeps f32: that
# moves a cosine by at most 2^-9 (sum |r_i||dq_i| <= 2^-9 |r||q|), so a
# bf16 store's batch is held to its single queries within PARITY_TOL + 2^-9
K4_TOL = 2e-5           # f32 abs; bf16: see BF16_ATTN_TOL
# K1, K3, K5 and K6 in bf16 round P to bf16 on the tensor cores: they take
# flash_attention_bf16_tolerance (K1 on its split heads); K4 also rounds
# q-hat and k-hat, and is held to the plain version that rounds them
# (joint_qkv_attention_bf16_reference) by the same bound on those q-hat
# and k-hat plus a term for rounding flips near a bf16 midpoint
# (joint_qkv_attention_bf16_tolerance); K7 f32 abs on unit-scale outputs
# (bf16: plus one ulp); K8 a fraction of max |out| (bf16: plus one ulp)
BF16_ATTN_TOL = "2e-5 + 1 bf16 ulp + 2^-8 x plain on |v|"
K7_TOL, K8_TOL = 1e-5, 1e-4
PARITY_TOL = 1e-4       # top-K scores, f32 slice on card vs CPU
# small imagination, f32 on the card (TF32 off, K4) against the CPU (plain
# versions): sums in other orders through 2 blocks give velocities within
# 5e-4 of ~3; 3 CFG steps at scale 4 amplify that to 2e-3 in the latents
TEXTQ_V_TOL, TEXTQ_LAT_TOL = 5e-4, 2e-3
# H100 SXM dense peaks (data sheet): bf16 on the tensor cores; f32 at the
# card's best f32-accurate rate, three TF32 products per f32 product on
# the tensor cores (495 TFLOP/s / 3; 67 outside them); HBM rate
TF32_FLOPS, HBM_BYTES_PER_S = 495e12, 3.35e12
PEAK_FLOPS = {torch.float32: TF32_FLOPS / 3, torch.bfloat16: 989e12}
F32_CUDA_CORE_FLOPS = 67e12     # f32 FMAs outside the tensor cores
K2_STORE = (131_080, 10, 1024)  # the default store: V1, K, D
SPINE_LIVE_VOXELS = 9_708 / 131_080   # the spine's store after 32 frames
PERSIST_ROWS = 653_780          # K2's kernel case's live rows
SEGMENT_CAPACITY = 4_096        # the segments phase's cut voxel_capacity
# segments-parity, card vs CPU: stored rows are the tokens themselves; the
# running sums (a few unit-normal tokens, atomics on the card) and the
# forgetting pass's group means differ by a few f32 ulps of values < ~10
SEG_PARITY_TOL = 1e-4


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


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one fn() in ms without the host's share: n calls
    captured in one CUDA graph, its replay timed as cuda_ms times it, over
    n.  cuda_ms's one event pair per call also counts the host's Python
    and launch work between the events, which a short kernel does not
    hide."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    ms = cuda_ms(g.replay, reps=reps, warmup=1) / n
    del g
    return ms


def host_ms(fn, n: int = 200) -> float:
    """Host time of one fn() in ms: n calls enqueued back to back, over n,
    without waiting for the device (200 launches fit the launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


# the kernels' names in the order of ``wrappers``; K2b is K2's Q-query
# scan (its own entry point and count)
NAMES = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K2b")


def wrappers() -> tuple:
    """The wrappers of K1-K8 and K2b, each holding its launch count."""
    from bsc_nav_tpu_torch.ops import conv2d, layernorm, similarity
    from bsc_nav_tpu_torch.ops import flash_attention as fa
    return (fa.short_attention_qkv, similarity.max_cosine_per_voxel,
            fa.short_attention, fa.joint_qkv_attention, fa.mid_attention,
            fa.flash_attention, layernorm.layer_norm, conv2d.conv3x3_s1,
            similarity.max_cosine_per_voxel_batch)


def counts() -> tuple:
    """Launch counts of (K1, ..., K8, K2b)."""
    return tuple(f.launches for f in wrappers())


def launches(**n) -> tuple:
    """A count tuple in ``NAMES``' order from keywords:
    launches(K1=24, K2=1)."""
    return tuple(n.get(k, 0) for k in NAMES)


def fmt(c) -> str:
    return ", ".join(f"{k} {n}" for k, n in zip(NAMES, c))


def add(a, b) -> tuple:
    return tuple(x + y for x, y in zip(a, b))


def since(before):
    return tuple(a - b for a, b in zip(counts(), before))


def reset_counts() -> None:
    for f in wrappers():
        f.launches = 0


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each element of x."""
    mag = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def unit_cos(a: np.ndarray, b: np.ndarray) -> float:
    return float((a * b).sum(-1).min())


def bound(flops: float, n_bytes: float, dtype) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for this work, the larger of flops over the dtype's peak (f32: three
    TF32 products per product) and bytes over the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_flops(B, H, Sq, Sk, hd, causal=False) -> float:
    """4 * hd flops per (query, key) pair attended: QK^T and PV."""
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
    return 4.0 * B * H * pairs * hd


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# the counted kernels, in the order of csrc/mma_bf16.cuh's TileKind: the
# tensor-core tiles, then K2b's two kernels (tensor cores: bf16 and int8
# rows; CUDA cores: f32 rows)
TILES = ("attention_wgmma_kernel", "attention_tf32_kernel",
         "conv3x3_s1_mma_kernel", "conv3x3_s1_tf32_kernel",
         "attention_tma_kernel", "max_cosine_mma_kernel",
         "max_cosine_batch_kernel")
K2B_KERNEL = {torch.float32: "max_cosine_batch_kernel",
              torch.bfloat16: "max_cosine_mma_kernel",
              torch.int8: "max_cosine_mma_kernel"}


def tile_kinds() -> int:
    """How many of TILES the built library counts (``bsc_tile_kinds``): a
    library built before the later kernels were added counts fewer (the
    first four where it has no ``bsc_tile_kinds``), so that this script
    also times such a build."""
    import ctypes

    from bsc_nav_tpu_torch.ops import _build
    try:
        return ctypes.c_int.in_dll(_build.kernels(), "bsc_tile_kinds").value
    except ValueError:
        return 4


def tile_launches() -> tuple:
    """The kernel library's launches of each of TILES, counted by the
    launchers where they launch them (``bsc_tile_launches``); 0 for a tile
    the library does not have."""
    import ctypes

    from bsc_nav_tpu_torch.ops import _build
    n = tile_kinds()
    got = tuple((ctypes.c_longlong * n).in_dll(
        _build.kernels(), "bsc_tile_launches"))
    return got + (0,) * (len(TILES) - n)


def check_tile(fn, tag: str, tile: str, what: str) -> int:
    """fn() runs once: every launch that the wrapper ``tag`` (K1
    "short_attention_qkv", K3 "short_attention", K4 "joint_qkv_attention",
    K5 "mid_attention", K6 "flash_attention", K8 "conv3x3_s1", K2b
    "max_cosine_per_voxel_batch") counted in that call, at least
    one, took ``tile``, and no other kernel of its kind (attention, conv
    or the scan) ran, by the launchers' own counts (``tile_launches``).
    Returns how many there were."""
    i = [f.__name__ for f in wrappers()].index(tag)
    before, tiles = counts(), tile_launches()
    fn()
    torch.cuda.synchronize()
    n = since(before)[i]
    took = dict(zip(TILES, (a - b for a, b in zip(tile_launches(), tiles))))
    kind = [t for t in TILES if t.split("_")[0] == tile.split("_")[0]]
    check(n > 0 and took[tile] == n and sum(took[t] for t in kind) == n,
          f"{what}: {n} launches of {tag!r} counted, tiles launched {took}")
    return n


# the tile each attention kernel runs, by dtype (K4, and K5 and K6 at
# head_dim 64, in bf16: TMA_TILE); K8's kernels
F32_TILE, BF16_TILE, TMA_TILE = TILES[1], TILES[0], TILES[4]
K8_TILES = {torch.float32: TILES[3], torch.bfloat16: TILES[2]}


def long_bf16_tile() -> str:
    """The tile of K5 and K6 in bf16 at head_dim 64: TMA_TILE, or in a
    library built before it existed, BF16_TILE."""
    return TMA_TILE if tile_kinds() > 4 else BF16_TILE


def sdpa_ms(q, k, v, causal=False) -> float:
    """One torch.nn.functional.scaled_dot_product_attention call on the
    same [B, H, S, hd] inputs: the library yardstick, timed only."""
    import torch.nn.functional as F
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def k2_bound(f, norms, cnt, qs):
    """Per voxel, how far two f32 evaluations of its max cosine may lie
    apart (tests/test_torch_similarity.py ``_dot_bound``): 2 gamma_{D+1}
    sum_i |r_i||q_i| / max(norm, 1e-12) over its live rows, plus 1e-5;
    qs [Q, D] as the kernel holds them -> [Q, V1]."""
    from bsc_nav_tpu_torch.ops.similarity import masked_norms
    V1, D = cnt.shape[0], f.shape[1]
    K = f.shape[0] // V1
    u = 2.0 ** -24
    gamma = (D + 1) * u / (1 - (D + 1) * u)
    absdot = (f.float().abs() @ qs.float().abs().T).T          # [Q, VK]
    mnorm = masked_norms(norms, cnt, K)
    rows = torch.where(mnorm > 0, 2 * gamma * absdot / mnorm.clamp_min(1e-12),
                       torch.zeros_like(absdot))
    return 1e-5 + rows.reshape(-1, V1, K).amax(dim=-1)


def k2_check(got, want, bound, what) -> float:
    """Equal -inf pattern, live voxels within ``bound``; the max error."""
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          f"{what}: -inf pattern differs")
    live = torch.isfinite(want)
    diff = (got[live] - want[live]).abs()
    check(bool((diff <= bound[live]).all()),
          f"{what}: {int((diff > bound[live]).sum())} voxels outside the "
          "f32 dot bound")
    return diff.max().item()


def gemm_scan(f, norms, cnt, qs):
    """The library composition of a Q-query scan, timed beside the kernel:
    one GEMM of the rows against the queries in the store dtype (int8
    rows copied to bf16 first, bf16 out), then the count mask, the divide
    and the max over each voxel's K rows."""
    from bsc_nav_tpu_torch.ops.similarity import _per_voxel_max
    rows = f.to(torch.bfloat16) if f.dtype == torch.int8 else f
    dots = torch.mm(rows, qs.to(rows.dtype).T).T.float()
    return _per_voxel_max(dots, norms, cnt)


def k2b_case(f, n, cnt, qq, dtype, store="random counts") -> dict:
    """K2b on rows f (the store dtype ``dtype``) and queries qq [Q, D]:
    the kernel each launch took (``K2B_KERNEL``), the result within the f32
    dot bound of its plain version with the same -inf pattern, and the
    kernel, plain and GEMM-composition times beside the bound."""
    from bsc_nav_tpu_torch.ops import similarity as sim

    Q, name = qq.shape[0], str(dtype)[6:]
    what = f"K2b {name} Q {Q} ({store})"
    check_tile(lambda: sim.max_cosine_per_voxel_batch(f, n, cnt, qq),
               "max_cosine_per_voxel_batch", K2B_KERNEL[dtype], what)
    # the queries as K2b holds them: rounded to the store dtype, bf16 for
    # int8 rows; an int8 or bf16 row times a bf16 query is exact in f32,
    # the bf16 tensor cores' product
    qdt = torch.float32 if dtype == torch.float32 else torch.bfloat16
    got = sim.max_cosine_per_voxel_batch(f, n, cnt, qq)
    want = sim.reference_max_cosine_batch(f, n, cnt, qq)
    err = k2_check(got, want, k2_bound(f, n, cnt, qq.to(qdt)), what)
    ms = cuda_ms(lambda: sim.max_cosine_per_voxel_batch(f, n, cnt, qq))
    plain = cuda_ms(lambda: sim.reference_max_cosine_batch(f, n, cnt, qq))
    lib = cuda_ms(lambda: gemm_scan(f, n, cnt, qq))
    # bytes: live rows and norms, counts, queries, [Q, V1] out; operations:
    # 2 Q D a live row at the card's rate for the products' type (f32:
    # three TF32 products; bf16 and int8 rows: bf16); beside it the same
    # operations on the CUDA cores' f32 FMAs, the limit of the f32 kernel
    live, V1, D = int(cnt.sum()), cnt.shape[0], f.shape[1]
    flops = 2.0 * D * Q * live
    b_ms, b_by = bound(flops, live * (D * f.element_size() + 4)
                       + nbytes(cnt, qq, got), qdt)
    t_fma = flops / F32_CUDA_CORE_FLOPS * 1e3
    live_vox = int((cnt > 0).sum())
    log("kernels", f"K2-batch max_cosine_per_voxel_batch {name} Q={Q} "
        f"{store} ({live_vox:,} of {V1:,} voxels, {live:,} rows live) on "
        f"{K2B_KERNEL[dtype]}: max_abs_err {err:.3g} (tol: the f32 dot "
        f"bound) kernel {ms:.4f} ms ({ms / Q:.4f} a query; {b_ms / ms:.3f} "
        f"of the bound) plain {plain:.4f} ms GEMM composition {lib:.4f} ms "
        f"bound {b_ms:.4f} ms ({b_by}); the CUDA cores' f32 FMAs "
        f"{t_fma:.4f} ms")
    return {"kernel": "K2b", "dtype": name, "Q": Q, "store": store,
            "device_kernel": K2B_KERNEL[dtype], "live_voxels": live_vox,
            "live_rows": live, "max_abs_err": err,
            "tol": "f32 dot bound", "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "cuda_core_fma_ms": t_fma, "library_ms": lib,
            "library": "GEMM + mask + max (torch.mm in the store dtype; "
                       "int8 via a bf16 copy)"}


def ptxas_usage(source: str, kernel: str) -> dict:
    """{mangled name: {registers, stack_frame, spill_stores, spill_loads}}
    (bytes) of the
    kernels whose names contain ``kernel``, from ptxas -v on ``source`` in
    this process's build (empty when the library was already built)."""
    from bsc_nav_tpu_torch.ops import _build
    out, name = {}, None
    for line in _build.ptxas_log.get(source, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(stack_frame=int(m[1]),
                                            spill_stores=int(m[2]),
                                            spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m[1])
    return out


def k2_cases(dev, gen, cases):
    """K2 at the default store (V1 131,080 x 10 x 1024, random counts) on
    f32 and bf16 rows, then the Q-query scan K2b at Q 1, 3 and 16 on f32,
    bf16 and int8 rows (the int8 store by quantize_feat_rows; a single
    query on int8 rows is K2b at Q 1) and at Q 16 on the same rows with
    the spine's share of live voxels, each against its plain version and
    the GEMM composition (``k2b_case``); first ptxas's registers and
    spills of max_cosine.cu's kernels."""
    from bsc_nav_tpu_torch.memory.store import quantize_feat_rows
    from bsc_nav_tpu_torch.ops import similarity as sim

    V1, K, D = K2_STORE
    feats = torch.randn(V1 * K, D, generator=gen, device=dev)
    norms = torch.linalg.norm(feats, dim=1)
    cnt = torch.randint(0, K + 1, (V1,), generator=gen, device=dev,
                        dtype=torch.int32)
    q = torch.randn(D, generator=gen, device=dev)
    q = q / torch.linalg.norm(q)
    qs = torch.randn(16, D, generator=gen, device=dev)
    qs = qs / torch.linalg.norm(qs, dim=1, keepdim=True)
    live = int(cnt.sum())
    # the spine's share of live voxels, each with 1..K rows
    sparse = torch.where(
        torch.rand(V1, generator=gen, device=dev) < SPINE_LIVE_VOXELS,
        torch.randint(1, K + 1, (V1,), generator=gen, device=dev,
                      dtype=torch.int32), 0).to(torch.int32)
    for inst, use in ptxas_usage("max_cosine.cu", "max_cosine_").items():
        log("kernels", f"K2/K2b ptxas {inst}: {use}")
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        if dtype == torch.int8:
            f, n, _ = quantize_feat_rows(feats, norms)
        else:
            f, n = feats.to(dtype), norms
        name = str(dtype)[6:]
        if dtype != torch.int8:
            got = sim.max_cosine_per_voxel(f, n, cnt, q)
            want = sim.reference_max_cosine(f, n, cnt, q)
            tol = f"{K2_TOL} abs + 1e-5 rel"
            err = k2_check(got, want, K2_TOL + 1e-5 * want.abs(),
                           f"K2 {name}")
            ms = cuda_ms(lambda: sim.max_cosine_per_voxel(f, n, cnt, q))
            plain = cuda_ms(lambda: sim.reference_max_cosine(f, n, cnt, q))
            store_bytes = nbytes(f)
            # the scan reads only live rows (k < count): count what this
            # store's counts need -- rows and their norms, counts, q,
            # output; the f32 query makes every product an f32 product
            b_ms, b_by = bound(2.0 * D * live,
                               live * (D * f.element_size() + 4)
                               + nbytes(cnt, q, got), torch.float32)
            log("kernels", f"K2 max_cosine_per_voxel V1={V1} K={K} D={D} "
                f"{name} store {store_bytes / 1e9:.2f} GB ({live:,} live "
                f"rows): max_abs_err {err:.3g} (tol: {tol}) kernel "
                f"{ms:.4f} ms plain {plain:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by}); no one PyTorch call computes a per-voxel max "
                f"over a count mask")
            cases.append({"kernel": "K2", "V1": V1, "K": K, "D": D,
                          "dtype": name, "store_bytes": store_bytes,
                          "live_rows": live, "max_abs_err": err,
                          "tol": tol, "ms": ms, "plain_ms": plain,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None})
        for Q in (1, 3, 16):
            cases.append(k2b_case(f, n, cnt, qs[:Q].contiguous(), dtype))
        cases.append(k2b_case(f, n, sparse, qs, dtype, store="sparse"))
        del f, n
    del feats, norms, cnt, sparse, q, qs
    torch.cuda.empty_cache()


def phase_kernels(dev, gen):
    import torch.nn.functional as F

    from bsc_nav_tpu_torch.ops import flash_attention as fa
    from bsc_nav_tpu_torch.ops import similarity as sim

    cases = []
    for B in (8, 32):
        for dtype in (torch.float32, torch.bfloat16):
            S, H, hd = 261, 16, 64
            qkv = torch.randn(B, S, 3 * H * hd, generator=gen, device=dev
                              ).to(dtype)
            cases.append(k1_case(qkv, H, dtype, {"B": B, "S": S}))
            del qkv
    k2_cases(dev, gen, cases)

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
            if dtype == torch.bfloat16:
                tol = fa.flash_attention_bf16_tolerance(q, k, v, want, causal)
                tol_s = BF16_ATTN_TOL
            else:
                tol, tol_s = K3_TOL, f"{K3_TOL}"
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            check(bool((diff <= tol).all()), f"K3 {case} {dtype}: err {err}")
            ms = cuda_ms(lambda: fa.short_attention(q, k, v, causal))
            plain = cuda_ms(
                lambda: fa.short_attention_reference(q, k, v, causal))
            lib = sdpa_ms(q, k, v, causal)
            if dtype == torch.float32:
                sdpa_kernels(q, k, v, causal, f"K3 {case} shape")
            # the same calls replayed from a CUDA graph: device time alone
            dev_ms = graph_ms(lambda: fa.short_attention(q, k, v, causal))
            lib_dev = graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            flops = attn_flops(B, H, Sq, Sk, hd, causal)
            b_ms, b_by = bound(flops, nbytes(q, k, v, got), dtype)
            log("kernels", f"K3 short_attention {case} B={B} {H}x{hd} "
                f"Sq={Sq} Sk={Sk} causal={causal} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g} (tol {tol_s}) kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the "
                f"bound) plain {plain:.4f} ms sdpa {lib:.4f} ms bound "
                f"{b_ms:.4f} ms ({b_by}); replayed from a CUDA graph: kernel "
                f"{dev_ms:.4f} ms ({b_ms / dev_ms:.3f} of the bound), sdpa "
                f"{lib_dev:.4f} ms")
            cases.append({"kernel": "K3", "case": case, "B": B, "heads": H,
                          "Sq": Sq, "Sk": Sk, "head_dim": hd,
                          "causal": causal, "dtype": str(dtype)[6:],
                          "max_abs_err": err, "tol": tol_s, "ms": ms,
                          "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib,
                          "tflops": flops / ms / 1e9,
                          "bound_share": b_ms / ms, "graph_ms": dev_ms,
                          "library_graph_ms": lib_dev})
            del q, k, v, got, want, diff, tol

    # K1 at the CLIP vision shape, from a fused qkv: the JAX dispatch sends
    # this shape to K3 (head_dim 80), K1 is timed beside it for comparison
    for dtype in (torch.float32, torch.bfloat16):
        B, S, H, hd = 12, 257, 16, 80
        qkv = torch.randn(B, S, 3 * H * hd, generator=gen, device=dev
                          ).to(dtype)
        cases.append(k1_case(qkv, H, dtype, {"case": "clip-vision-shape",
                                             "B": B, "S": S}))
        del qkv
    k4_cases(dev, gen, cases)
    long_attention_cases(dev, gen, cases)
    layer_norm_cases(dev, gen, cases)
    conv_cases(dev, gen, cases)
    torch.cuda.empty_cache()
    return cases


def k1_case(qkv, H, dtype, keys) -> dict:
    """K1 on one fused qkv [B, S, 3*H*hd] against its plain version (f32:
    K1_TOL; bf16: short_attention_qkv_bf16_tolerance), with its time by
    CUDA events and replayed from a CUDA graph, beside the plain version
    and SDPA on the split heads."""
    import torch.nn.functional as F

    from bsc_nav_tpu_torch.ops import flash_attention as fa

    B, S, threeD = qkv.shape
    hd = threeD // 3 // H
    got = fa.short_attention_qkv(qkv, H)
    want = fa.short_attention_qkv_reference(qkv, H)
    if dtype == torch.bfloat16:
        tol = fa.short_attention_qkv_bf16_tolerance(qkv, H, want)
        tol_s = BF16_ATTN_TOL
    else:
        tol, tol_s = K1_TOL, f"{K1_TOL}"
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    check(bool((diff <= tol).all()), f"K1 {keys} {dtype}: err {err}")
    ms = cuda_ms(lambda: fa.short_attention_qkv(qkv, H))
    plain = cuda_ms(lambda: fa.short_attention_qkv_reference(qkv, H))
    q, k, v = (t.contiguous() for t in fa._split_heads(qkv, H))
    lib = sdpa_ms(q, k, v)
    if dtype == torch.float32 and B == 8:
        sdpa_kernels(q, k, v, False, f"K1 shape B={B} S={S}")
    dev_ms = graph_ms(lambda: fa.short_attention_qkv(qkv, H))
    lib_dev = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    flops = attn_flops(B, H, S, S, hd)
    b_ms, b_by = bound(flops, nbytes(qkv, got), dtype)
    tag = " ".join(f"{k}={v}" for k, v in keys.items())
    log("kernels", f"K1 short_attention_qkv {tag} {H}x{hd} "
        f"{str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol_s}) kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of "
        f"the bound) plain {plain:.4f} ms sdpa {lib:.4f} ms bound "
        f"{b_ms:.4f} ms ({b_by}); replayed from a CUDA graph: kernel "
        f"{dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / dev_ms:.3f} of the bound), sdpa {lib_dev:.4f} ms")
    return {"kernel": "K1", **keys, "heads": H, "head_dim": hd,
            "dtype": str(dtype)[6:], "max_abs_err": err, "tol": tol_s,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "tflops": flops / ms / 1e9,
            "bound_share": b_ms / ms, "graph_ms": dev_ms,
            "library_graph_ms": lib_dev}


def sdpa_kernels(q, k, v, causal, what) -> None:
    """Log the device kernels one SDPA call runs on these inputs (the
    library yardstick of K1 and K3 in f32, of K5 and K6 in bf16), whose
    kernel name says which of PyTorch's attention back ends it took."""
    import torch.nn.functional as F

    from bsc_nav_tpu_torch.profiling import device_kernels
    names = device_kernels(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    log("kernels", f"SDPA {str(q.dtype)[6:]} at the {what}: device kernels "
        f"{sorted(set(n[:100] for n in names))}")


def normalised_qkv(x, c, heads, g, eps=1e-6):
    """[B, H, S, 64] q, k, v of K4's inputs with the qk-norm applied (q not
    scaled), in the input dtype: what SDPA would need to compute K4."""
    from bsc_nav_tpu_torch.ops import flash_attention as fa
    return tuple(t.to(x.dtype).contiguous() for t in
                 fa.joint_normalised_qkv(x, c, heads, *g, eps=eps))


def k4_tile(dtype):
    """The tile K4 runs in ``dtype``: TMA_TILE in bf16, F32_TILE in f32
    (after its qk-norm pre-pass); in a tree from before the pre-pass
    (no ``joint_qk_norm``), BF16_TILE in bf16 and None in f32 (its
    CUDA-core kernel, counted by no launcher)."""
    from bsc_nav_tpu_torch.ops import flash_attention as fa
    if hasattr(fa, "joint_qk_norm"):
        return TMA_TILE if dtype == torch.bfloat16 else F32_TILE
    return BF16_TILE if dtype == torch.bfloat16 else None


def k4_prepass(x, c, H, g, dtype) -> dict:
    """K4's qk-norm pre-pass alone (``joint_qk_norm``) against its plain
    version -- v exact; q-hat and k-hat within 2^-17 of the plain f32
    value, so in bf16 equal or one ulp apart where that value rounds the
    other way -- and its device time (graph) beside its bound (bytes), and
    "pre-pass + SDPA" on its rows for context.  Empty where the tree has
    no pre-pass."""
    import torch.nn.functional as F

    from bsc_nav_tpu_torch.ops import flash_attention as fa
    if not hasattr(fa, "joint_qk_norm"):
        return {}
    D = x.shape[2] // 3
    got = fa.joint_qk_norm(x, c, H, *g)
    want = fa.joint_qk_norm_reference(x, c, H, *g)
    check(torch.equal(got[..., 2 * D:], want[..., 2 * D:]),
          f"K4 pre-pass {dtype}: v not copied exactly")
    a, w = got[..., :2 * D].float(), want[..., :2 * D].float()
    tol = (2.0 ** -17 * w.abs() if dtype == torch.float32
           else torch.where(a == w, torch.zeros_like(w), bf16_ulp(w)))
    err = (a - w).abs().max().item()
    check(bool(((a - w).abs() <= tol).all()),
          f"K4 pre-pass {dtype}: err {err}")
    del a, w, tol, want
    ms = graph_ms(lambda: fa.joint_qk_norm(x, c, H, *g))
    b_ms, _ = bound(0.0, nbytes(x, c, got), dtype)

    def then_sdpa():
        q, k, v = fa._split_heads(fa.joint_qk_norm(x, c, H, *g), H)
        return F.scaled_dot_product_attention(q, k, v)

    with_sdpa = graph_ms(then_sdpa)
    del got
    return {"prepass_max_abs_err": err, "prepass_graph_ms": ms,
            "prepass_bound_ms": b_ms, "prepass_sdpa_graph_ms": with_sdpa}


# (case, B, heads, Sx, Sc, dtypes); head_dim 64
K4_SHAPES = (("joint", 6, 24, 1024, 589, (torch.float32, torch.bfloat16)),
             ("joint-no-t5", 6, 24, 1024, 154,
              (torch.float32, torch.bfloat16)),
             ("self", 6, 24, 1024, 0, (torch.float32, torch.bfloat16)),
             ("self-1024px", 6, 24, 4096, 0, (torch.bfloat16,)))


def k4_cases(dev, gen, cases):
    """K4 at the SD3.5-medium shapes: B 6 (3 images x CFG 2), 24 heads x
    64, 1024 latent rows plus 77 CLIP + 512 T5 context rows, 77 + 77 when
    T5 is absent, and the dual-attention self-attention (no context) at
    512^2 (S 1024) and, in bf16, at 1024^2 (S 4096).  bf16 is held to
    the plain version of its order, which rounds q-hat and k-hat to bf16.
    The S 4096 case is held to it on the first and the last batch row, and
    the plain version timed on the first: the plain logits of the whole
    call would be 9.7 GB.  Each case checks the tile its call took, and
    times the qk-norm pre-pass alone (``k4_prepass``)."""
    import torch.nn.functional as F

    from bsc_nav_tpu_torch.ops import flash_attention as fa

    for case, B, H, Sx, Sc, dtypes in K4_SHAPES:
        D = H * 64
        for dtype in dtypes:
            x = torch.randn(B, Sx, 3 * D, generator=gen, device=dev).to(dtype)
            c = torch.randn(B, Sc, 3 * D, generator=gen, device=dev).to(dtype)
            g = [torch.rand(64, generator=gen, device=dev) * 1.5 + 0.25
                 for _ in range(4)]
            got = fa.joint_qkv_attention(x, c, H, *g)
            plain_fn = (fa.joint_qkv_attention_bf16_reference
                        if dtype == torch.bfloat16
                        else fa.joint_qkv_attention_reference)
            # the plain side one batch row at a time, first and last, where
            # the whole call's logits would not fit
            n = 1 if case == "self-1024px" else B
            err = 0.0
            for rows in ((slice(0, 1), slice(B - 1, B)) if n < B
                         else (slice(0, B),)):
                want = plain_fn(x[rows], c[rows], H, *g)
                if dtype == torch.bfloat16:
                    tol = fa.joint_qkv_attention_bf16_tolerance(
                        x[rows], c[rows], H, *g, want)
                    tol_s = (f"{BF16_ATTN_TOL} on bf16 q-hat, k-hat + "
                             "rounding flips")
                else:
                    tol, tol_s = K4_TOL, f"{K4_TOL}"
                diff = (got[rows].float() - want.float()).abs()
                err = max(err, diff.max().item())
                check(bool((diff <= tol).all()),
                      f"K4 {case} {dtype} rows {rows}: err {err}")
                del want, tol, diff
            tile = k4_tile(dtype)
            if tile:
                check_tile(lambda: fa.joint_qkv_attention(x, c, H, *g),
                           "joint_qkv_attention", tile,
                           f"K4 {case} {dtype}")
            xs, cs = x[:n], c[:n]
            ms = cuda_ms(lambda: fa.joint_qkv_attention(x, c, H, *g))
            plain = cuda_ms(lambda: plain_fn(xs, cs, H, *g),
                            reps=5 if n < B else 20)
            dev_ms = graph_ms(lambda: fa.joint_qkv_attention(x, c, H, *g))
            qn, kn, vn = normalised_qkv(x, c, H, g)
            sdpa = sdpa_ms(qn, kn, vn)
            sdpa_dev = graph_ms(
                lambda: F.scaled_dot_product_attention(qn, kn, vn))
            del qn, kn, vn
            pre = k4_prepass(x, c, H, g, dtype)
            pre_s = (f"; the pre-pass alone (graph) "
                     f"{pre['prepass_graph_ms']:.4f} ms (bound "
                     f"{pre['prepass_bound_ms']:.4f} ms, bytes; "
                     f"max_abs_err {pre['prepass_max_abs_err']:.3g}), "
                     f"pre-pass + SDPA on its rows (graph) "
                     f"{pre['prepass_sdpa_graph_ms']:.4f} ms" if pre else "")
            S = Sx + Sc
            flops = attn_flops(B, H, S, S, 64)
            b_ms, b_by = bound(flops, nbytes(x, c, got, *g), dtype)
            log("kernels", f"K4 joint_qkv_attention {case} B={B} {H}x64 "
                f"Sx={Sx} Sc={Sc} (S {S}) {str(dtype)[6:]}: max_abs_err "
                f"{err:.3g} (tol {tol_s}"
                f"{f'; checked on batch rows 0 and {B - 1}' if n < B else ''}"
                f") kernel "
                f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{b_ms / ms:.3f} of the bound) plain {plain:.4f} ms"
                f"{' (batch row 0)' if n < B else ''} bound {b_ms:.4f} ms "
                f"({b_by}); replayed from a CUDA graph: kernel "
                f"{dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s, "
                f"{b_ms / dev_ms:.3f} of the bound); {tile}{pre_s}; no "
                f"PyTorch call applies the qk-norm -- for context only, "
                f"SDPA on the already-normalised q/k/v {sdpa:.4f} ms, graph "
                f"{sdpa_dev:.4f} ms")
            cases.append({"kernel": "K4", "case": case, "B": B, "heads": H,
                          "Sx": Sx, "Sc": Sc, "head_dim": 64,
                          "dtype": str(dtype)[6:], "max_abs_err": err,
                          "tol": tol_s,
                          "checked_batch_rows": 2 if n < B else B, "ms": ms,
                          "plain_ms": plain, "plain_batch_rows": n,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": None, "tflops": flops / ms / 1e9,
                          "bound_share": b_ms / ms, "graph_ms": dev_ms,
                          "tile": tile, **pre,
                          "sdpa_on_normalised_ms": sdpa,
                          "sdpa_on_normalised_graph_ms": sdpa_dev})
            del x, c, got, xs, cs
            torch.cuda.empty_cache()


# (kernel, case, B, heads, S, causal); head_dim 64
LONG_ATTENTION = (("K5", "sd3-medium-512", 6, 24, 1613, False),
                  ("K5", "dinov2-518", 8, 16, 1374, False),
                  ("K6", "sd35-medium-1024", 6, 24, 4685, False),
                  ("K6", "causal", 2, 16, 2048, True))


def long_attention_cases(dev, gen, cases, kernels=("K5", "K6")):
    """K5 at SD3-medium's joint attention at 512^2 (B 6 = 3 images x CFG 2,
    24 heads x 64, S 1024 + 589) and at DINOv2 ViT-L at 518^2 (B 8, 16x64,
    S 1374); K6 at SD3.5-medium's joint attention at 1024^2 (B 6, 24x64,
    S 4096 + 589) and causal at B 2, 16x64, S 2048: the cases of
    ``kernels``.  Each by events and by a CUDA graph replay, beside SDPA;
    the device kernels SDPA runs in bf16 at the two main shapes.  The
    plain versions build their logits in 1 GB chunks of B*H."""
    import torch.nn.functional as F

    from bsc_nav_tpu_torch.ops import flash_attention as fa

    for kernel, case, B, H, S, causal in LONG_ATTENTION:
        if kernel not in kernels:
            continue
        if kernel == "K5":
            name, fn, plain = ("mid_attention", fa.mid_attention,
                               fa.mid_attention_reference)
        else:
            name = "flash_attention"

            def fn(q, k, v):
                return fa.flash_attention(q, k, v, causal)

            def plain(q, k, v):
                return fa.flash_attention_reference(q, k, v, causal)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(B, H, S, 64, generator=gen, device=dev
                                   ).to(dtype) for _ in range(3))
            got, want = fn(q, k, v), plain(q, k, v)
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                tol, tol_s = K3_TOL, f"{K3_TOL}"
            else:   # P rounded to bf16 on the tensor cores
                tol = fa.flash_attention_bf16_tolerance(q, k, v, want, causal)
                tol_s = BF16_ATTN_TOL
            err = diff.max().item()
            check(bool((diff <= tol).all()),
                  f"{kernel} {case} {dtype}: err {err}")
            tile = F32_TILE if dtype == torch.float32 else long_bf16_tile()
            n = check_tile(lambda: fn(q, k, v), name, tile,
                           f"{kernel} {case} {dtype}")
            log("kernels", f"{kernel} {name} {case} {str(dtype)[6:]}: "
                f"{n} launch counted, {tile}")
            ms = cuda_ms(lambda: fn(q, k, v))
            plain_ms = cuda_ms(lambda: plain(q, k, v))
            lib = sdpa_ms(q, k, v, causal)
            flops = attn_flops(B, H, S, S, 64, causal)
            b_ms, b_by = bound(flops, nbytes(q, k, v, got), dtype)
            if dtype == torch.bfloat16 and case in ("sd3-medium-512",
                                                    "sd35-medium-1024"):
                sdpa_kernels(q, k, v, causal, f"{kernel} {case} shape")
            # device time alone, as K1 and K3
            graph = {"graph_ms": graph_ms(lambda: fn(q, k, v)),
                     "library_graph_ms": graph_ms(
                         lambda: F.scaled_dot_product_attention(
                             q, k, v, is_causal=causal))}
            log("kernels", f"{kernel} {name} {case} B={B} {H}x64 S={S} "
                f"causal={causal} {str(dtype)[6:]}: max_abs_err {err:.3g} "
                f"(tol {tol_s}) kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the "
                f"bound) plain {plain_ms:.4f} ms sdpa {lib:.4f} ms bound "
                f"{b_ms:.4f} ms ({b_by}); replayed from a CUDA graph: "
                f"kernel {graph['graph_ms']:.4f} ms "
                f"({flops / graph['graph_ms'] / 1e9:.1f} TFLOP/s, "
                f"{b_ms / graph['graph_ms']:.3f} of the bound), sdpa "
                f"{graph['library_graph_ms']:.4f} ms; {tile}")
            cases.append({"kernel": kernel, "case": case, "B": B, "heads": H,
                          "S": S, "head_dim": 64, "causal": causal,
                          "dtype": str(dtype)[6:], "max_abs_err": err,
                          "tol": tol_s, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": lib, "tflops": flops / ms / 1e9,
                          "bound_share": b_ms / ms, **graph, "tile": tile})
            del q, k, v, got, want, diff, tol
        torch.cuda.empty_cache()


def layer_norm_cases(dev, gen, cases):
    """K7 at ViT-L's token grids [8 | 32, 261, 1024], against its plain
    version and F.layer_norm (K7 is dispatched nowhere, as in the JAX
    package)."""
    import torch.nn.functional as F

    from bsc_nav_tpu_torch.ops import layernorm as ln

    D = 1024
    g, b = (torch.randn(D, generator=gen, device=dev) for _ in range(2))
    for B in (8, 32):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(B, 261, D, generator=gen, device=dev) * 3 + 1
                 ).to(dtype)
            got = ln.layer_norm(x, g, b)
            want = ln.layer_norm_reference(x, g, b)
            diff = (got.float() - want.float()).abs()
            tol = K7_TOL + (bf16_ulp(want) if dtype == torch.bfloat16 else 0)
            err = diff.max().item()
            check(bool((diff <= tol).all()), f"K7 B={B} {dtype}: err {err}")
            ms = cuda_ms(lambda: ln.layer_norm(x, g, b))
            plain = cuda_ms(lambda: ln.layer_norm_reference(x, g, b))
            gd, bd = g.to(dtype), b.to(dtype)
            lib = cuda_ms(lambda: F.layer_norm(x, (D,), gd, bd, 1e-6))
            # events around one short call also count the host's work:
            # the same calls replayed from a CUDA graph give device time
            dev_ms = graph_ms(lambda: ln.layer_norm(x, g, b))
            lib_dev = graph_ms(lambda: F.layer_norm(x, (D,), gd, bd, 1e-6))
            # ... and the host's share: the wrapper's work per call
            host = host_ms(lambda: ln.layer_norm(x, g, b))
            lib_host = host_ms(lambda: F.layer_norm(x, (D,), gd, bd, 1e-6))
            # per element: the two sums, centre, square, scale, affine
            b_ms, b_by = bound(8.0 * x.numel(), nbytes(x, got, g, b), dtype)
            log("kernels", f"K7 layer_norm [{B}, 261, {D}] {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g} (tol {K7_TOL}"
                f"{' + 1 bf16 ulp' if dtype == torch.bfloat16 else ''}) "
                f"kernel {ms:.4f} ms plain {plain:.4f} ms F.layer_norm "
                f"{lib:.4f} ms bound {b_ms:.4f} ms ({b_by}); replayed from "
                f"a CUDA graph: kernel {dev_ms:.4f} ms ({b_ms / dev_ms:.3f} "
                f"of the bound), F.layer_norm {lib_dev:.4f} ms; host work "
                f"per call: kernel {host:.4f} ms, F.layer_norm "
                f"{lib_host:.4f} ms; dispatched nowhere")
            cases.append({"kernel": "K7", "B": B, "S": 261, "D": D,
                          "dtype": str(dtype)[6:], "max_abs_err": err,
                          "tol": K7_TOL, "ms": ms, "plain_ms": plain,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": lib, "bound_share": b_ms / ms,
                          "graph_ms": dev_ms, "library_graph_ms": lib_dev,
                          "graph_bound_share": b_ms / dev_ms,
                          "host_ms": host, "library_host_ms": lib_host})
            del x, got, want, diff


# YOLOv8x-worldv2's 3x3 stride-1 convs at 640^2 (H = W, C -> CO, count per
# forward): the K8 route's whole population, 76 launches per f32 forward;
# 40^2 x 640 -> 640 runs in no conv of the model and is kept for
# continuity with the measurements before it had a path
YOLO_CONVS = ((160, 80, 80, 6), (80, 160, 160, 19), (80, 320, 320, 2),
              (80, 320, 80, 1), (80, 80, 80, 1), (40, 320, 320, 27),
              (40, 640, 320, 1), (40, 640, 80, 1), (40, 80, 80, 1),
              (20, 320, 320, 14), (20, 640, 320, 1), (20, 640, 80, 1),
              (20, 80, 80, 1), (40, 640, 640, 0))
K8_PER_FORWARD = sum(n for *_, n in YOLO_CONVS)


def conv_cases(dev, gen, cases):
    """K8 at YOLOv8x-worldv2's 3x3 stride-1 shapes, B 8, bf16 and f32,
    against its plain version and cuDNN (F.conv2d on the channels-last
    view, bias, SiLU; TF32 off).  The detector's f32 convs take K8; its
    bf16 convs would take cuDNN (conv_bn_act)."""
    import torch.nn.functional as F

    from bsc_nav_tpu_torch.ops import conv2d

    B = 8
    for HW, C, CO, per_fwd in YOLO_CONVS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(B, HW, HW, C, generator=gen, device=dev).to(dtype)
            w = (torch.randn(9, C, CO, generator=gen, device=dev)
                 / math.sqrt(9 * C)).to(dtype)
            bias = torch.randn(CO, generator=gen, device=dev)
            got = conv2d.conv3x3_s1(x, w, bias)
            want = conv2d.conv3x3_s1_reference(x, w, bias)
            diff = (got.float() - want.float()).abs()
            tol = K8_TOL * want.float().abs().max() + (
                bf16_ulp(want) if dtype == torch.bfloat16 else 0)
            err = diff.max().item()
            case = f"{HW}x{HW}x{C}->{CO}"
            check(bool((diff <= tol).all()), f"K8 {case} {dtype}: err {err}")
            check_tile(lambda: conv2d.conv3x3_s1(x, w, bias), "conv3x3_s1",
                       K8_TILES[dtype], f"K8 {case} {dtype}")
            ms = cuda_ms(lambda: conv2d.conv3x3_s1(x, w, bias))
            plain = cuda_ms(lambda: conv2d.conv3x3_s1_reference(x, w, bias))
            xc = x.permute(0, 3, 1, 2)              # NCHW view, NHWC memory
            wc = w.reshape(3, 3, C, CO).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bc = bias.to(dtype)
            lib = cuda_ms(lambda: F.silu(F.conv2d(xc, wc, bc, padding=1)))
            dev_ms = graph_ms(lambda: conv2d.conv3x3_s1(x, w, bias))
            lib_dev = graph_ms(
                lambda: F.silu(F.conv2d(xc, wc, bc, padding=1)))
            flops = 2.0 * B * HW * HW * C * CO * 9
            b_ms, b_by = bound(flops, nbytes(x, w, bias, got), dtype)
            where = (f"{per_fwd} per forward" if per_fwd else
                     "on no path")
            log("kernels", f"K8 conv3x3_s1 B={B} {case} {str(dtype)[6:]} "
                f"({where}): max_abs_err {err:.3g} (tol {K8_TOL} of max "
                f"|out|{' + 1 bf16 ulp' if dtype == torch.bfloat16 else ''})"
                f" kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{b_ms / ms:.3f} of the bound) plain {plain:.4f} ms cuDNN "
                f"{lib:.4f} ms bound {b_ms:.4f} ms ({b_by}); replayed from "
                f"a CUDA graph: kernel {dev_ms:.4f} ms ({b_ms / dev_ms:.3f} "
                f"of the bound), cuDNN {lib_dev:.4f} ms; {K8_TILES[dtype]}")
            cases.append({"kernel": "K8", "case": case, "B": B, "H": HW,
                          "W": HW, "C": C, "CO": CO, "dtype": str(dtype)[6:],
                          "per_forward": per_fwd,
                          "max_abs_err": err, "tol": K8_TOL, "ms": ms,
                          "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib,
                          "tflops": flops / ms / 1e9,
                          "bound_share": b_ms / ms, "graph_ms": dev_ms,
                          "library_graph_ms": lib_dev,
                          "graph_bound_share": b_ms / dev_ms,
                          "tile": K8_TILES[dtype]})
            del x, w, got, want, diff, xc, wc
    # per f32 forward, summed over the population by its counts
    for dtype in ("float32", "bfloat16"):
        k8 = [c for c in cases if c["kernel"] == "K8" and c["dtype"] == dtype]
        tot = {k: sum(c[k] * c["per_forward"] for c in k8)
               for k in ("graph_ms", "library_graph_ms", "bound_ms")}
        log("kernels", f"K8 {dtype} over one forward's "
            f"{K8_PER_FORWARD} 3x3 stride-1 convs at B 8 (graph): kernel "
            f"{tot['graph_ms']:.3f} ms, cuDNN {tot['library_graph_ms']:.3f}"
            f" ms, bound {tot['bound_ms']:.3f} ms")
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
        check(d == launches(K1=vcfg.depth),
              f"flush {i}: K1-K8 +{d} (want K1 +{vcfg.depth} only)")
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
        check(d == launches(K1=vcfg.depth, K2=1),
              f"query {i}: K1-K8 +{d} (want K1 +{vcfg.depth}, K2 +1)")
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
    # one more query: every K1 launch is this dtype's tile (f32: the TF32
    # tile)
    tile = F32_TILE if dtype == torch.float32 else BF16_TILE
    n_k1 = check_tile(lambda: mem.voxel_localized(
        queries[0], K=cfg.query.top_k), "short_attention_qkv", tile,
        f"{name} checked query")
    log(name, f"checked query: {n_k1} K1 launches, all {tile}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(name, f"num_voxels {nv} dropped {int(mem.state.dropped_voxels)}; "
        f"flush ms (8 frames each) {[round(t, 3) for t in flush_ms]}; "
        f"steady median {statistics.median(flush_ms[1:]):.3f}; query ms "
        f"({QUERY_IMAGES} images, top-{cfg.query.top_k}) "
        f"{[round(t, 3) for t in query_ms]}; peak device memory "
        f"{peak:.2f} GB")
    result = {"dtype": str(dtype)[6:], "num_voxels": nv,
              "flush_ms": flush_ms, "query_ms": query_ms,
              "peak_gb": peak, "k1_tile": tile}
    return result, mem


@contextlib.contextmanager
def uncounted():
    """Launches inside do not count: the checks that hold a path's result
    against a plain version or another call run here."""
    saved = counts()
    try:
        yield
    finally:
        for f, n in zip(wrappers(), saved):
            f.launches = n


def live_tops(out):
    """A voxel_localized tuple's (positions, scores) as numpy."""
    return np.asarray(out[1]), np.asarray(out[2], np.float64)


def topk_agree(a, b, tol, what) -> float:
    """Two top-K results of one store agree: as many live voxels, sorted
    scores within ``tol`` (each voxel's score within tol moves the k-th
    score by at most tol), and every voxel above the k-th score + 2 tol in
    one is in the other's top-K.  Returns the max score difference."""
    (pa, sa), (pb, sb) = live_tops(a), live_tops(b)
    check(len(sa) == len(sb) > 0, f"{what}: {len(sa)} / {len(sb)} live")
    err = float(np.abs(np.sort(sa) - np.sort(sb)).max())
    check(err <= tol, f"{what}: score err {err} > {tol}")
    for (p1, s1), p2 in (((pa, sa), pb), ((pb, sb), pa)):
        sure = set(map(tuple, p1[s1 > s1.min() + 2 * tol]))
        check(sure <= set(map(tuple, p2)), f"{what}: top-K sets differ")
    return err


def goal_prompts(frames, n):
    """n distinct image prompts of 3 views each from the spin's frames."""
    return [np.stack([frames[(2 * i + j) % len(frames)][0]["rgb"][:, :, :3]
                      for j in range(3)]) for i in range(n)]


def phase_batch(dev, mem, cfg, vcfg, world):
    """Batched queries on the slice's store: the robot's growing-radius
    sweep (one prompt at radii 30, 40, 50 around the first query's best
    voxel), 16 distinct image prompts, and a Q 17 call past the 16-query
    chunk; each result against its own ``voxel_localized`` call.  The
    single calls are the checks' yardstick: their launches do not count."""
    name = f"batch {str(mem.state.feats.dtype)[6:]}"
    env, frames, queries = world
    K, depth = cfg.query.top_k, vcfg.depth
    tol = PARITY_TOL + (2.0 ** -9 if mem.state.feats.dtype
                        == torch.bfloat16 else 0.0)

    def single(prompt, radius=np.inf, grid=None):
        with uncounted():
            before = counts()
            out = mem.voxel_localized(prompt, K=K, region_radius=radius,
                                      curr_grid=grid)
            check(since(before) == launches(K1=depth, K2=1),
                  f"{name}: single query launched {fmt(since(before))}")
        return out

    def batched(prompts, radii=None, grid=None, distinct=None):
        before = counts()
        t0 = time.perf_counter()
        out = mem.voxel_localized_batch(prompts, K=K, region_radii=radii,
                                        curr_grid=grid)
        ms = (time.perf_counter() - t0) * 1e3
        want = launches(K1=depth * (distinct or len(prompts)),
                        K2b=-(-len(prompts) // 16))
        check(since(before) == want, f"{name}: Q {len(prompts)} launched "
              f"{fmt(since(before))} (want {fmt(want)})")
        return out, ms

    first = single(queries[0])
    best = first[0][0]
    radii = [30.0, 40.0, 50.0]
    t0 = time.perf_counter()
    sweep_singles = [single(queries[0], r, best) for r in radii]
    sweep_single_ms = (time.perf_counter() - t0) * 1e3
    sweep, sweep_ms = batched([queries[0]] * 3, radii, best, distinct=1)
    errs = []
    for r, b, s_ in zip(radii, sweep, sweep_singles):
        errs.append(topk_agree(s_, b, tol, f"{name} sweep r {r}"))
        d2 = ((np.asarray(b[1]) - best) ** 2).sum(axis=1)
        check(bool((d2 <= r * r).all()), f"{name}: voxel outside r {r}")

    goals = goal_prompts(frames, 16)
    t0 = time.perf_counter()
    goal_singles = [single(g) for g in goals]
    goal_single_ms = (time.perf_counter() - t0) * 1e3
    multi, multi_ms = batched(goals)
    for i, (b, s_) in enumerate(zip(multi, goal_singles)):
        errs.append(topk_agree(s_, b, tol, f"{name} goal {i}"))
    q17, q17_ms = batched(goals + [queries[0]])
    for i, (b, s_) in enumerate(zip(q17, goal_singles + [first])):
        errs.append(topk_agree(s_, b, tol, f"{name} Q17 {i}"))
    err = max(errs)
    log(name, f"sweep (1 prompt x 3 radii {radii}) {sweep_ms:.2f} ms "
        f"batched against {sweep_single_ms:.2f} ms for 3 single queries; "
        f"16 goals {multi_ms:.2f} ms batched against {goal_single_ms:.2f} "
        f"ms for 16 single queries; Q 17 {q17_ms:.2f} ms (K2b +2); "
        f"top-{K} sets equal to the single queries', max score err "
        f"{err:.3g} (tol {tol:.3g}); no voxel outside its radius")
    return {"dtype": str(mem.state.feats.dtype)[6:], "sweep_ms": sweep_ms,
            "sweep_single_ms": sweep_single_ms, "goals16_ms": multi_ms,
            "goals16_single_ms": goal_single_ms, "q17_ms": q17_ms,
            "max_score_err": err, "tol": tol}


def phase_int8(dev, mem32, cfg, vcfg, world):
    """The same 32 frames into an int8 store with the f32 slice's encoder,
    then the 3 image queries on it (a single query on int8 rows is K2b at
    Q 1).  Returns the agent and what the checks need."""
    from bsc_nav_tpu_torch.agents.spatial_memory import VoxelTokenMemory

    env, frames, queries = world
    depth = vcfg.depth
    mem = VoxelTokenMemory(cfg, env, mem32.perception,
                           store_dtype=torch.int8)
    flush_ms = []
    for i in range(N_FRAMES // BATCH):
        before = counts()
        t0 = time.perf_counter()
        for obs, pose in frames[i * BATCH:(i + 1) * BATCH]:
            mem.push_frame(obs, pose)
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        check(since(before) == launches(K1=depth),
              f"int8 flush {i}: {fmt(since(before))}")
    tops, query_ms = [], []
    for imgs in queries:
        before = counts()
        t0 = time.perf_counter()
        tops.append(mem.voxel_localized(imgs, K=cfg.query.top_k))
        query_ms.append((time.perf_counter() - t0) * 1e3)
        check(since(before) == launches(K1=depth, K2b=1),
              f"int8 query: {fmt(since(before))} (want K2b at Q 1)")
        check(len(tops[-1][1]) > 0 and bool(np.isfinite(tops[-1][2]).all()),
              "int8 query: empty or non-finite top-K")
    return mem, tops, flush_ms, query_ms


def int8_checks(mem8, mem32, tops8, world, cases):
    """The int8 ingest equals quantize_store of the f32 store over the
    live rows, byte for byte (feats) and to the bit (feat_scale,
    feat_norm); the int8 scan (K2b at Q 1) within the f32 dot bound of its
    plain version; the top-K overlap with the f32 store's."""
    from bsc_nav_tpu_torch.memory.store import quantize_store
    from bsc_nav_tpu_torch.ops import similarity as sim

    s8, s32 = mem8.state, mem32.state
    nv = int(s32.num_voxels)
    check(int(s8.num_voxels) == nv, "int8 store: another voxel count")
    for f in ("slot_pos", "feat_count"):
        check(torch.equal(getattr(s8, f)[:nv], getattr(s32, f)[:nv]),
              f"int8 store: {f} differs from the f32 store's")
    check(torch.equal(s8.slot_map, s32.slot_map), "int8 store: slot_map")
    q = quantize_store(s32)
    K = s32.feats.shape[0] // s32.feat_count.shape[0]
    live = (torch.arange(K, device=s8.feats.device)[None, :]
            < s8.feat_count[:nv, None]).reshape(-1)
    rows = int(live.sum())
    for f in ("feats", "feat_scale", "feat_norm"):
        a, b = getattr(s8, f)[:nv * K][live], getattr(q, f)[:nv * K][live]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)   # to the bit
        check(torch.equal(a, b), f"int8 ingest {f} != quantize_store's")
    qv = mem8.perception.pool_step(mem8.perception.vit_params,
                                   torch.from_numpy(world[2][0]).to(
                                       s8.feats.device))
    qv = (qv / torch.linalg.norm(qv)).contiguous()
    got = sim.max_cosine_per_voxel(s8.feats, s8.feat_norm, s8.feat_count,
                                   qv)
    want = sim.reference_max_cosine(s8.feats, s8.feat_norm, s8.feat_count,
                                    qv)
    err = k2_check(got, want, k2_bound(
        s8.feats, s8.feat_norm, s8.feat_count,
        qv.to(torch.bfloat16).float()[None])[0], "int8 scan on the store")
    overlap = []
    for imgs, t8 in zip(world[2], tops8):
        t32 = mem32.voxel_localized(imgs, K=len(t8[1]))
        overlap.append(len(set(map(tuple, t8[1]))
                           & set(map(tuple, t32[1]))) / max(len(t8[1]), 1))
    scans = [(f"K2 {c['dtype']}", c) for c in cases if c["kernel"] == "K2"]
    scans += [(f"K2b Q 1 {c['dtype']}", c) for c in cases
              if c["kernel"] == "K2b" and c["Q"] == 1]
    log("int8", f"{nv} voxels, {rows:,} live rows: the int8 ingest equals "
        f"quantize_store of the f32 store byte for byte (feats) and to the "
        f"bit (feat_scale, feat_norm); the int8 scan (K2b at Q 1) against "
        f"its plain version on the store max_abs_err {err:.3g} (the f32 dot "
        f"bound); top-{len(tops8[0][1])} overlap with the f32 store's "
        f"{[round(o, 3) for o in overlap]}; single-query scans at the "
        f"kernel case (ms, bound): " + ", ".join(
            f"{d} {c['ms']:.4f} / {c['bound_ms']:.4f}" for d, c in scans))
    return {"live_rows": rows, "k2_int8_err": err, "overlap": overlap}


def phase_persist(dev, cfg, seed, mem8):
    """save_npz then load_npz of an int8 store of 65,378 full voxels
    (653,780 rows x 1024, 0.67 GB of codes: the kernel case's live size),
    and of the 32-frame int8 store: every field array-equal, and a query
    gives the same top-K.  Persistence launches no kernel: the queries
    that compare the saved store with the loaded one do not count.  Files
    go to a temporary directory under the repository's build/."""
    import tempfile

    from bsc_nav_tpu_torch.memory import persistence
    from bsc_nav_tpu_torch.memory.query import localize
    from bsc_nav_tpu_torch.memory.store import (
        VoxelStoreState, init_store, quantize_feat_rows)
    from bsc_nav_tpu_torch.ops import _build

    m = cfg.memory
    K, D, G, H = m.cache_size, m.token_dim, m.grid_size, m.num_height_cells
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = init_store(m, torch.int8, device=dev)
    n = PERSIST_ROWS // K
    rows = n * K
    qi, qn, sc = quantize_feat_rows(
        torch.randn(rows, D, generator=gen, device=dev),
        torch.ones(rows, device=dev))
    st.feats[:rows], st.feat_norm[:rows], st.feat_scale[:rows] = qi, qn, sc
    del qi, qn, sc
    st.feat_dist[:rows] = torch.rand(rows, generator=gen, device=dev)
    st.feat_count[:n] = K
    stride = G * G * H // n
    lin = (torch.arange(n, device=dev) * stride + torch.randint(
        0, stride, (n,), generator=gen, device=dev))
    st.slot_pos[:n] = torch.stack([lin // (G * H), (lin // H) % G, lin % H],
                                  dim=1).to(torch.int32)
    st.slot_map[lin] = torch.arange(n, dtype=torch.int32, device=dev)
    st.rgb_sum[:n] = 255 * torch.rand(n, 3, generator=gen, device=dev)
    st.weight[:n] = torch.rand(n, generator=gen, device=dev)
    st.cv_map.copy_(torch.randint(0, 256, st.cv_map.shape, generator=gen,
                                  device=dev).to(torch.uint8))
    st.max_height.copy_(torch.randint(-1, H, st.max_height.shape,
                                      generator=gen, device=dev).int())
    st.num_voxels.fill_(n)
    st.initialized.fill_(True)
    q = torch.randn(D, generator=gen, device=dev)
    fields = VoxelStoreState.__dataclass_fields__
    out = {"voxels": n, "rows": rows, "feats_gb": rows * D / 1e9}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        path = os.path.join(tmp, "store.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        persistence.save_npz(st, path)
        out["save_s"] = time.perf_counter() - t0
        out["file_gb"] = os.path.getsize(path) / 1e9
        t0 = time.perf_counter()
        ld = persistence.load_npz(path, m, store_dtype=torch.int8,
                                  device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        for f in fields:
            check(torch.equal(getattr(ld, f), getattr(st, f)),
                  f"persist: {f} differs after the round trip")
        with uncounted():
            a, b = (localize(s_, q, top_k=cfg.query.top_k)
                    for s_ in (st, ld))
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              "persist: the loaded store answers another top-K")
        del ld
        # the 32-frame int8 store: its live prefix and full maps round-trip
        s8 = mem8.state
        nv = int(s8.num_voxels)
        path = os.path.join(tmp, "spin.npz")
        persistence.save_npz(s8, path)
        ld = persistence.load_npz(path, m, store_dtype=torch.int8,
                                  device=dev)
        prefix = {"slot_pos": nv, "feat_count": nv, "rgb_sum": nv,
                  "weight": nv, "feats": nv * K, "feat_norm": nv * K,
                  "feat_scale": nv * K, "feat_dist": nv * K}
        for f in fields:
            if f in ("feat_sum", "feat_obs"):
                continue           # size-1 under the dist policy
            a, b = getattr(ld, f), getattr(s8, f)
            if f in prefix:
                a, b = a[:prefix[f]], b[:prefix[f]]
            check(torch.equal(a, b), f"persist: the spin store's {f}")
        qv = torch.randn(D, generator=gen, device=dev)
        with uncounted():
            a, b = (localize(s_, qv, top_k=cfg.query.top_k)
                    for s_ in (s8, ld))
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              "persist: the spin store answers another top-K")
    log("persist", f"int8 store of {n:,} voxels ({rows:,} rows, "
        f"{out['feats_gb']:.2f} GB of codes): save_npz {out['save_s']:.1f} s "
        f"({out['file_gb']:.2f} GB compressed), load_npz "
        f"{out['load_s']:.1f} s; every field array-equal, the same top-"
        f"{cfg.query.top_k}; the 32-frame int8 store ({nv} voxels) too")
    del st
    torch.cuda.empty_cache()
    return out


def phase_int8_encoder(dev, cfg, vcfg, world, params32):
    """Perception.create with encoder_int8 (random-init ViT-L, the f32
    slice's weights quantized): one flush of 8 frames and one query; every
    block matmul through linear_q8, K1 launches as in f32."""
    import dataclasses as dc

    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import vit

    env, frames, queries = world
    qcfg = cfg.replace(models=dc.replace(cfg.models, encoder_int8=True))
    perc = Perception.create(qcfg, vit_params=params32, batch_size=BATCH,
                             device=dev)
    check(perc.vit_params.quantized, "encoder_int8: the ViT is not int8")
    calls = [0]
    linear_q8 = vit.linear_q8

    def counted(x, p):
        calls[0] += 1
        return linear_q8(x, p)

    vit.linear_q8 = counted
    try:
        mem = VoxelTokenMemory(qcfg, env, perc)
        before = counts()
        t0 = time.perf_counter()
        for obs, pose in frames[:BATCH]:
            mem.push_frame(obs, pose)
        torch.cuda.synchronize()
        flush_ms = (time.perf_counter() - t0) * 1e3
        check(since(before) == launches(K1=vcfg.depth),
              f"int8 encoder flush: {fmt(since(before))}")
        check(calls[0] == 4 * vcfg.depth,
              f"int8 encoder flush: {calls[0]} linear_q8 calls")
        before = counts()
        t0 = time.perf_counter()
        out = mem.voxel_localized(queries[0], K=cfg.query.top_k)
        query_ms = (time.perf_counter() - t0) * 1e3
        check(since(before) == launches(K1=vcfg.depth, K2=1),
              f"int8 encoder query: {fmt(since(before))}")
        check(calls[0] == 8 * vcfg.depth,
              f"int8 encoder query: {calls[0]} linear_q8 calls in all")
        check(len(out[1]) > 0 and bool(np.isfinite(out[2]).all()),
              "int8 encoder query: empty or non-finite top-K")
    finally:
        vit.linear_q8 = linear_q8
    return perc, mem, {"flush_ms": flush_ms, "query_ms": query_ms,
                       "linear_q8_calls": calls[0]}


def int8_encoder_checks(dev, cfg, params32, world, res):
    """The int8 encoder's pooled query token on the card against the same
    int8 encoder on the CPU (plain versions), from the f32 slice's weights
    with layer scales of 1: random init has 1e-5, which keeps the blocks'
    matmuls from reaching the pooled token (as in
    tests/test_torch_batch_query.py).  The weights are quantized once, on
    the card, and the CPU runs the same int8 leaves.  The two sides' f32
    activations differ by sums in other orders, which may flip an
    activation code at a rounding boundary: the pools are held within
    2e-3 of their max |value| and to a cosine of 0.9999, the CPU test's
    bound, and the f32 encoder's pool on the card must lie outside that
    bound, so that it tells the two paths apart.  The CPU's own
    quantize_params must give the card's leaves, bit for bit (the weight
    scales are a true division on both, ``quant.weight_scale``); counted
    beside it, the scales where the card's ``x / 127.0`` differs from that
    division."""
    import dataclasses as dc

    from bsc_nav_tpu_torch.agents.spatial_memory import Perception
    from bsc_nav_tpu_torch.models import vit

    qcfg = cfg.replace(models=dc.replace(cfg.models, encoder_int8=True))
    sd = {k: torch.ones_like(v) if k.split(".")[-1] in ("ls1", "ls2")
          else v for k, v in params32.state_dict().items()}
    p = vit.ViT(params32.cfg, device=dev)
    p.load_state_dict(sd)
    x = torch.from_numpy(world[2][0]).to(dev)
    perc = Perception.create(qcfg, vit_params=p, device=dev)
    got = perc.pool_step(perc.vit_params, x).double().cpu()
    plain = Perception.create(cfg, vit_params=p, device=dev).pool_step(
        p, x).double().cpu()
    q8 = {k: v.cpu() for k, v in perc.vit_params.state_dict().items()}
    amax = p.blocks[0].qkv.w.abs().amax(dim=0).clamp(min=1e-12)
    n_recip = int((amax / 127.0 != amax / torch.full_like(amax, 127.0)
                   ).sum())
    del p, perc
    torch.cuda.empty_cache()
    cpu = vit.ViT(params32.cfg, device="cpu", quantized=True)
    cpu.load_state_dict(q8)
    want = Perception.create(cfg, vit_params=cpu, device="cpu").pool_step(
        cpu, x.cpu()).double()
    p_cpu = vit.ViT(params32.cfg, device="cpu")
    p_cpu.load_state_dict({k: v.cpu() for k, v in sd.items()})
    own = vit.quantize_params(p_cpu).state_dict()
    differ = {t: sum(int((q8[k] != own[k]).sum()) for k in q8
                     if k.endswith(t)) for t in ("w_q", "w_s")}
    sizes = {t: sum(q8[k].numel() for k in q8 if k.endswith(t))
             for t in ("w_q", "w_s")}
    del cpu, p_cpu, own

    def cos(a, b):
        return float(a @ b / torch.linalg.norm(a) / torch.linalg.norm(b))

    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    err_f32 = float((plain - want).abs().max()) / scale
    c, c_f32 = cos(got, want), cos(plain, want)
    check(math.isfinite(err) and err <= 2e-3 and c >= 0.9999,
          f"int8 encoder: card against CPU {err:.3g} of max |value|, "
          f"cos {c}")
    check(err_f32 > 2e-3, f"int8 encoder: the f32 pool lies {err_f32:.3g} "
          "of max |value| from the int8 pool, inside the bound")
    check(not any(differ.values()), f"int8 encoder: the CPU's quantize_"
          f"params differs from the card's in {differ} leaf elements")
    res.update(pooled_err_vs_cpu=err, pooled_cos_vs_cpu=c,
               f32_pool_err=err_f32, f32_pool_cos=c_f32,
               cpu_quantize_differs=differ, leaves=sizes,
               scalar_div_differs=n_recip, scales_tried=amax.numel())
    log("int8 encoder", f"ViT-L with int8 qkv/proj/fc1/fc2 (linear_q8, "
        f"{res['linear_q8_calls']} calls): flush of {BATCH} frames "
        f"{res['flush_ms']:.2f} ms, query ({QUERY_IMAGES} images) "
        f"{res['query_ms']:.2f} ms; with layer scales 1, the pooled token "
        f"on the card against the same int8 leaves on the CPU: {err:.3g} "
        f"of max |value|, cos {c:.8f} (bound 2e-3, 0.9999); the f32 "
        f"encoder's pool {err_f32:.3g}, cos {c_f32:.8f}; the CPU's own "
        f"quantize_params gives the card's {sizes['w_q']:,} codes and "
        f"{sizes['w_s']:,} scales bit for bit; on the card, block 0 qkv's "
        f"absmax / 127.0 (a Python scalar) differs from that true division "
        f"in {n_recip} of {amax.numel()} scales")
    return res


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
        check(d == launches(K3=SCORE_REPS * L_v + L_t),
              f"clip {name} score: K1-K8 +{d}")
        before = counts()
        s_img = m.score(views, queries[0][0])
        best = m.best("bed", labels)
        d = since(before)
        check(d == launches(K3=2 * L_v + 2 * L_t),
              f"clip {name} image score + best: K1-K8 +{d}")
        for s in (s_txt, s_img):
            check(s.shape == (N_VIEWS,) and bool(np.isfinite(s).all())
                  and abs(float(s.sum()) - 1) < 1e-4,
                  f"clip {name}: bad scores {s}")
        check(0 <= best < len(labels), f"clip {name}: best {best}")
        # one more score: the towers keep f32 activations (int8 too), so
        # every K3 launch is the TF32 tile
        n_k3 = check_tile(lambda: m.score(views, "a bed"),
                          "short_attention", F32_TILE,
                          f"clip {name} checked score")
        log("clip", f"CLIPMatcher {name} checked score: {n_k3} K3 "
            f"launches, all {F32_TILE}")
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
        check(d == launches(K1=vcfg.depth, K3=L_v - 1),
              f"detector flush {i}: K1-K8 +{d} (want K1 +{vcfg.depth}, "
              f"K3 +{L_v - 1})")
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
    n_k3 = check_tile(lambda: det.embed(np.stack(
        [o["rgb"] for o, _ in frames[:BATCH]])), "short_attention",
        F32_TILE, "clip detector checked embed")
    log("clip", f"ClipPatchDetector checked embedding of {BATCH} frames: "
        f"{n_k3} K3 launches, all {F32_TILE}")

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


# ---------------------------------------------------------------------------
# phase: YOLO-World -> the device long-term feed
# ---------------------------------------------------------------------------

# bench.py:47-51's 20 detection classes
DETECT_CLASSES = (
    "bed", "sofa", "chair", "table", "plant", "tv", "toilet", "sink",
    "refrigerator", "oven", "microwave", "lamp", "cabinet", "counter",
    "shelf", "mirror", "picture", "curtain", "pillow", "towel")
# K8 per conv is within 1e-4 of max |out| of its plain version (K8_TOL);
# a level's logits pass 19-32 K8 convs with gains ~1 on the way, so the
# forward with K8 is held to its plain version on the card at 1e-3 of each
# level's max |logit|
YOLO_FWD_TOL = 1e-3
YOLO_PASS = 6           # candidates a frame over the confidence, median


def seeded_text(seed, n, dim):
    """n seeded unit vectors (bench.py:365-367's stand-in for the class
    embeddings)."""
    t = np.random.default_rng(seed).normal(size=(n, dim))
    return (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)


def set_logit_bias(Y, params, levels, conf):
    """Set every head level's logit_bias so that the median frame has
    YOLO_PASS anchors whose best class passes ``conf`` (bench.py:380-386's
    stress rate, here in the weights: random weights give near-uniform
    classes).  levels: a forward's output at the current bias."""
    best = torch.cat([c.amax(-1).reshape(c.shape[0], -1)
                      for _, c in levels], 1)
    top = best.topk(YOLO_PASS + 1, dim=1).values
    # the threshold midway between the median frame's 6th and 7th
    kth = (top[:, -2].median() + top[:, -1].median()) / 2
    shift = math.log(conf / (1 - conf)) - float(kth)
    for hp in params["head"]:
        hp["logit_bias"] = hp["logit_bias"] + shift
    return float(params["head"][0]["logit_bias"])


def passing(levels, bias_shift, conf):
    """Anchors a frame whose best class passes conf after a bias shift."""
    best = torch.cat([c.amax(-1).reshape(c.shape[0], -1)
                      for _, c in levels], 1) + bias_shift
    return (torch.sigmoid(best) >= conf).sum(1).tolist()


def n_leaves(tree) -> int:
    """Parameters of a YOLO tree, K8's folded copies not counted."""
    if isinstance(tree, dict):
        return sum(n_leaves(v) for k, v in tree.items()
                   if k not in ("w9", "b9"))
    if isinstance(tree, list):
        return sum(n_leaves(v) for v in tree)
    return tree.numel()


def yolo_split(prof) -> dict:
    """Device time (ms) of a profiled detector call by kind: K8, cuDNN's
    convolutions, GEMMs (torch._int_mm, the NMS's bmm), the rest."""
    split = {"K8 conv3x3_s1": 0.0, "cuDNN convolutions": 0.0, "GEMMs": 0.0,
             "rest": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n, ms = e.name.lower(), e.time_range.elapsed_us() / 1e3
        if "conv3x3_s1" in n:
            split["K8 conv3x3_s1"] += ms
        elif any(t in n for t in ("conv", "fprop", "xmma", "cudnn")):
            split["cuDNN convolutions"] += ms
        elif any(t in n for t in ("gemm", "cutlass", "nvjet", "wmma")):
            split["GEMMs"] += ms
        else:
            split["rest"] += ms
    return split


@torch.no_grad()
def phase_yolo(dev, cfg, vcfg, world, seed):
    """YOLOv8x-worldv2 at 640^2 feeding VoxelTokenMemory(Config())'s
    long-term memory on the device, f32 and int8 neck, over the 32 frames
    (4 flushes of 8) beside the ViT-L ingest."""
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import vit
    from bsc_nav_tpu_torch.models import yolo_world as Y
    from bsc_nav_tpu_torch.ops import conv2d

    env, frames, _ = world
    ycfg = Y.YOLOV8X_WORLDV2
    check((ycfg.ch(64), ycfg.ch(1024), ycfg.n(3), ycfg.img_size)
          == (80, 640, 3, 640), "not YOLOv8x-worldv2 at 640^2")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Y.init_params(ycfg, torch.Generator(device=dev).manual_seed(
        seed), text_dim=ycfg.embed_dim, device=dev)
    torch.cuda.synchronize()
    n_par = n_leaves(params)
    log("yolo", f"YOLOv8x-worldv2 random init on {dev}: {n_par / 1e6:.1f} M "
        f"parameters ({n_par * 4 / 1e6:.0f} MB f32), folded for K8, "
        f"{time.perf_counter() - t0:.1f} s; class embeddings: "
        f"{len(DETECT_CLASSES)} seeded unit vectors of {ycfg.embed_dim} "
        f"(bench.py:365-367; no txt_proj), classes of bench.py:47-51")
    temb = seeded_text(seed, len(DETECT_CLASSES), ycfg.embed_dim)
    conf = cfg.detector.confidence
    det = Y.YoloWorldDetector(params, ycfg, DETECT_CLASSES, temb,
                              confidence=conf)
    rgbs = np.stack([o["rgb"][..., :3] for o, _ in frames[:BATCH]])
    x = det._images(rgbs)
    bias = set_logit_bias(Y, params, Y.forward(params, x, det.text_emb,
                                               ycfg), conf)
    # the K8 forward against the same forward with K8's plain version, on
    # two frames; every one of its 3x3 stride-1 convs took K8
    before = counts()
    got = Y.forward(params, x[:2], det.text_emb, ycfg)
    d = since(before)
    check(d == launches(K8=K8_PER_FORWARD), f"yolo forward: K1-K8 +{d}")
    n_pass = passing(got, 0.0, conf) + passing(
        Y.forward(params, x[2:], det.text_emb, ycfg), 0.0, conf)
    Y.conv3x3_s1 = conv2d.conv3x3_s1_reference
    try:
        want = Y.forward(params, x[:2], det.text_emb, ycfg)
    finally:
        Y.conv3x3_s1 = conv2d.conv3x3_s1
    errs = []
    for (gb, gc), (wb, wc) in zip(got, want):
        for g, w in ((gb, wb), (gc, wc)):
            errs.append(float((g - w).abs().max() / w.abs().max()))
            check(bool(torch.isfinite(g).all()), "yolo: non-finite logits")
    check(max(errs) <= YOLO_FWD_TOL, f"yolo forward, K8 vs plain: {errs}")
    log("yolo", f"logit_bias {bias:.4f} (seeded so that a median frame has "
        f"{YOLO_PASS} candidates over {conf}): candidates per frame "
        f"{n_pass}; forward (2 frames, 76 K8 launches) against K8's plain "
        f"version on the card: max err per level {max(errs):.3g} of its "
        f"max |logit| (tol {YOLO_FWD_TOL})")
    check(3 <= statistics.median(n_pass) <= 10,
          f"candidates per frame {n_pass}")
    # cuDNN's route turns TF32 off per call: with the process flag on (as
    # PyTorch starts), a 1x1 f32 conv still holds an f32 bound
    xt = torch.randn(8, 80, 80, 320, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    wt = torch.randn(1, 1, 320, 320, device=dev) / math.sqrt(320)
    torch.backends.cudnn.allow_tf32 = True
    try:
        y = conv2d.conv2d_same(xt, wt, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ref = (xt.double() @ wt[0, 0].double())
    tf32_err = float(((y - ref).abs() / (xt.abs().double()
                                         @ wt[0, 0].abs().double())).max())
    check(tf32_err < 1e-5, f"conv2d_same ran TF32: rel err {tf32_err}")

    vparams = vit.init_params(
        vcfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    perception = Perception.create(cfg, vit_params=vparams, batch_size=BATCH,
                                   device=dev)
    result = {"parameters": n_par, "logit_bias": bias,
              "candidates_per_frame": n_pass, "forward_vs_plain": max(errs),
              "conv2d_same_rel_err_tf32_flag_on": tf32_err,
              "class_embeddings": "seeded unit vectors (bench.py:365-367)"}
    G, Z = cfg.memory.grid_size, cfg.memory.zmax - cfg.memory.zmin
    variants = []
    # the main path: the counts are set to 0 just before it, read after it
    reset_counts()
    for name, p, k8 in (("f32", params, K8_PER_FORWARD),
                        ("int8-neck", Y.quantize_params(params), 36)):
        det = Y.YoloWorldDetector(p, ycfg, DETECT_CLASSES, temb,
                                  confidence=conf)
        n_new = []
        feed = det.detect_batch_instances

        def counted(*a, feed=feed, n_new=n_new):
            out = feed(*a)
            n_new.append(len(out))
            return out

        det.detect_batch_instances = counted
        mem = VoxelTokenMemory(cfg, env, perception, detector=det)
        flush_ms, per_flush = [], []
        for i in range(N_FRAMES // BATCH):
            before = counts()
            t0 = time.perf_counter()
            for obs, pose in frames[i * BATCH:(i + 1) * BATCH]:
                mem.push_frame(obs, pose)          # the 8th push flushes
            torch.cuda.synchronize()
            flush_ms.append((time.perf_counter() - t0) * 1e3)
            d = since(before)
            per_flush.append(d[7])
            check(d == launches(K1=vcfg.depth, K8=k8),
                  f"yolo {name} flush {i}: K1-K8 +{d} (want K1 "
                  f"+{vcfg.depth}, K8 +{k8})")
        inst = mem.long_memory_dict
        check(len(inst) > 0 and all(
            o["label"] in DETECT_CLASSES and 0 <= o["loc"][0] < G
            and 0 <= o["loc"][1] < G and 0 <= o["loc"][2] < Z
            and conf <= o["confidence"] <= 1 for o in inst),
            f"yolo {name}: {len(inst)} long-term instances, per flush "
            f"{n_new}")
        variants.append((name, p, det, feed, mem, flush_ms, per_flush,
                         n_new))
    path = counts()

    # the detector alone on the last 8 frames, and its parts, timed
    last = frames[N_FRAMES - BATCH:]
    rgbs = np.stack([o["rgb"][..., :3] for o, _ in last])
    depths = np.stack([np.asarray(o["depth"], np.float32) for o, _ in last])
    for name, p, det, feed, mem, flush_ms, per_flush, n_new in variants:
        tfs = np.stack([mem._host_cam_to_world(q) for _, q in last])
        det_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            feed(rgbs, depths, tfs, cfg)
            det_ms.append((time.perf_counter() - t0) * 1e3)
        xb = det._images(rgbs)
        fwd_ms = cuda_ms(lambda: Y.decode_topk_device(
            Y.forward(p, xb, det.text_emb, ycfg), ycfg, det.decode_k),
            reps=5, warmup=1)
        cand = Y.decode_topk_device(Y.forward(p, xb, det.text_emb, ycfg),
                                    ycfg, det.decode_k)
        nms_ms = cuda_ms(lambda: Y.nms_device(
            *cand, det.iou_thr, conf, det.keep_k), reps=5, warmup=1)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            feed(rgbs, depths, tfs, cfg)
            torch.cuda.synchronize()
        split = yolo_split(prof)
        busy = sum(split.values())
        log(f"yolo {name}", "profiled detector call, device time by kind "
            "(ms): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            + (f"; K8's share {split['K8 conv3x3_s1'] / busy:.3f}" if busy
               else "; the profiler returned no device time"))
        steady = statistics.median(flush_ms[1:])
        det_steady = statistics.median(det_ms)
        n_inst = len(mem.long_memory_dict)
        log(f"yolo {name}", f"VoxelTokenMemory(Config()) + "
            f"YoloWorldDetector over {N_FRAMES} frames: flush ms (8 frames, "
            f"ViT-L ingest + YOLO feed) {[round(t, 3) for t in flush_ms]}, "
            f"steady median {steady:.3f} ({BATCH / steady * 1e3:.1f} "
            f"frames/s); the detector alone (detect_batch_instances, 8 "
            f"frames, host clock) {[round(t, 3) for t in det_ms]} ms, "
            f"{BATCH / det_steady * 1e3:.1f} frames/s; forward + decode "
            f"{fwd_ms:.3f} ms, NMS ({det.decode_k} steps) {nms_ms:.3f} ms "
            f"(CUDA events); K8 launches per flush {per_flush}; instances "
            f"per flush {n_new}, long-term instances after integration "
            f"{n_inst}")
        result[name] = {"flush_ms": flush_ms, "flush_steady_ms": steady,
                        "frames_per_s": BATCH / steady * 1e3,
                        "detector_ms": det_ms,
                        "detector_frames_per_s": BATCH / det_steady * 1e3,
                        "forward_decode_ms": fwd_ms, "nms_ms": nms_ms,
                        "profiled_device_ms": split,
                        "k8_per_flush": per_flush, "instances": n_new,
                        "long_term_instances": n_inst}
        del cand, xb
    del variants, mem, det
    torch.cuda.empty_cache()
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del perception, vparams, params
    torch.cuda.empty_cache()
    return result, path


@torch.no_grad()
def phase_yolo_parity(dev, seed):
    """A reduced YOLO-World (depth 1/3, width 0.5, 160^2) on the card
    against the CPU: the device feed's instances over 4 spin frames with a
    generic camera transform each (so that no world point sits on a cell
    edge, where the last bit of a 3-term product decides the voxel)."""
    from bsc_nav_tpu_torch.config import Config
    from bsc_nav_tpu_torch.models import yolo_world as Y

    rcfg = Y.YoloWorldConfig(width=0.5, depth=1 / 3, img_size=160)
    cfg = Config()
    cpu = Y.init_params(rcfg, torch.Generator().manual_seed(seed),
                        text_dim=rcfg.embed_dim, device="cpu")
    temb = seeded_text(seed + 1, len(DETECT_CLASSES), rcfg.embed_dim)
    _, frames = spin_frames(cfg, seed, 4)
    rgbs = np.stack([o["rgb"][..., :3] for o, _ in frames])
    depths = np.stack([np.asarray(o["depth"], np.float32) for o, _ in frames])
    rng = np.random.default_rng(seed)
    tfs = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    for b in range(4):
        q = rng.normal(size=4)
        x, y, z, w = q / np.linalg.norm(q)
        tfs[b, :3, :3] = [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
        tfs[b, :3, 3] = rng.uniform(-1, 1, size=3)
    conf = 0.55
    # a logit scale of 100 (CLIP's), so that random weights' class
    # logits spread beyond the comparison's 1e-4
    for hp in cpu["head"]:
        hp["logit_scale"] = torch.tensor(math.log(100.0))
    det_c = Y.YoloWorldDetector(cpu, rcfg, DETECT_CLASSES, temb, conf)
    set_logit_bias(Y, cpu, Y.forward(cpu, det_c._images(rgbs),
                                     det_c.text_emb, rcfg), conf)
    card = tree_map(lambda t: t.to(dev), cpu)
    det_g = Y.YoloWorldDetector(card, rcfg, DETECT_CLASSES, temb, conf)
    before = counts()
    outs = [[t.cpu() for t in d.instances_device(rgbs, depths, tfs, cfg)]
            for d in (det_c, det_g)]
    check(since(before)[7] > 0, "yolo-parity: K8 never ran")
    # compared away from the threshold: a confidence within 1e-4 of it
    # may fall on either side
    sets, confs = [], []
    for locs, c, ci, ok in outs:
        keep = ok & ((c - conf).abs() > 1e-4)
        per = [sorted((int(ci[b, k]), tuple(locs[b, k].tolist()),
                       float(c[b, k])) for k in torch.nonzero(keep[b])[:, 0])
               for b in range(len(ok))]
        sets.append([[t[:2] for t in f] for f in per])
        confs.append([t[2] for f in per for t in f])
    n = sum(map(len, sets[0]))
    check(sets[0] == sets[1] and n > 0,
          f"yolo-parity: instances differ: {n} on the CPU, "
          f"{sum(map(len, sets[1]))} on the card")
    cerr = max(abs(a - b) for a, b in zip(*confs))
    check(cerr <= 1e-4, f"yolo-parity: confidence err {cerr}")
    log("yolo-parity", f"YOLO-World depth 1/3, width 0.5, 160^2, 4 frames: "
        f"{n} instances equal on the card and the CPU (grid ids, classes), "
        f"confidence err {cerr:.3g} (tol 1e-4)")
    return {"instances": n, "confidence_err": cerr}


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


def make_imagination(w, mcfg, t5_params, quantize, seed):
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import t5 as T5
    from bsc_nav_tpu_torch.models import vae as V
    from bsc_nav_tpu_torch.models.imagination import DiffusionImagination
    from bsc_nav_tpu_torch.models.tokenizer import default_tokenizer

    return DiffusionImagination(
        mmdit_params=w["mmdit"], mmdit_cfg=mcfg,
        vae_params=w["vae"], vae_cfg=V.SD3_VAE,
        clip_l_params=w["clip_l"], clip_l_cfg=C.SD3_CLIP_L,
        clip_g_params=w["clip_g"], clip_g_cfg=C.SD3_CLIP_G,
        tokenizer=default_tokenizer(), t5_params=t5_params,
        t5_cfg=T5.T5_XXL, t5_tokenizer=toy_t5_tokenizer(), t5_seq_len=512,
        quantize=quantize, seed=seed)


def kernel_split(prof) -> tuple:
    """Device time (ms) of the profiled kernels by kind, and the five
    largest kernels (by summed time) among the rest."""
    kinds = (("joint_qkv", "K4 joint_qkv_attention"),
             ("mid_attention", "K5 mid_attention"),
             ("flash_attention", "K6 flash_attention"),
             ("short_attention", "K1/K3 attention"))
    split = {k: 0.0 for _, k in kinds}
    split.update({"GEMMs": 0.0, "convolutions (VAE)": 0.0, "rest": 0.0})
    rest = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n, ms = e.name, e.time_range.elapsed_us() / 1e3
        low = n.lower()
        kind = next((k for tag, k in kinds if tag in n), None)
        if kind:
            split[kind] += ms
        elif "conv" in low or "fprop" in low or "dgrad" in low:
            split["convolutions (VAE)"] += ms
        elif any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet")):
            split["GEMMs"] += ms
        else:
            split["rest"] += ms
            rest[n[:60]] = rest.get(n[:60], 0.0) + ms
    return split, sorted(rest.items(), key=lambda kv: -kv[1])[:5]


def phase_textq(dev, name, cfg, vcfg, world, imagination, seed, per_query,
                n_queries=N_TEXT_QUERIES):
    """VoxelTokenMemory(Config()) over the 32 frames with the imagination;
    voxel_localized(TEXT_PROMPT) n_queries times, each checked to launch
    the DINOv2 encode's K1, one K2, the CLIP-L/G towers' K3 and the MMDiT's
    ``per_query`` launches (e.g. {"K4": 1036}), then once under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import t5 as T5
    from bsc_nav_tpu_torch.models import vit

    env, frames, _ = world
    mcfg = imagination.mmdit_cfg
    side = 8 * mcfg.input_size                 # the SD3 VAE upsamples x8
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

    k3_per_query = 2 * (C.SD3_CLIP_L.text_layers + C.SD3_CLIP_G.text_layers)
    want = launches(K1=vcfg.depth, K2=1, K3=k3_per_query, **per_query)
    query_ms = []
    tiles = tile_launches()
    for i in range(n_queries):
        before = counts()
        t0 = time.perf_counter()
        best, pos, sims = mem.voxel_localized(TEXT_PROMPT, K=cfg.query.top_k)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        d = since(before)
        check(d == want, f"{name} query {i}: K1-K8 +{d} (want +{want})")
        check(len(pos) > 0 and bool(np.isfinite(sims).all())
              and bool((np.abs(sims) <= 1 + 1e-5).all())
              and bool((np.diff(sims) <= 0).all()),
              f"{name} query {i}: bad top-K {sims[:5]}")
        imgs = mem.last_imagined
        check(imgs.dtype == torch.uint8
              and tuple(imgs.shape) == (imagination.num_images, side, side,
                                        3),
              f"{name}: images {imgs.dtype} {tuple(imgs.shape)}")
        check(float(imgs.float().std()) > 0, f"{name}: flat images")
    peak = torch.cuda.max_memory_allocated() / 1e9
    img_stats = (float(imgs.float().mean()), float(imgs.float().std()))
    # every K4, K5 and K6 launch of the queries (bf16, head_dim 64) took
    # the TMA tile, and nothing else did
    n_long = n_queries * sum(per_query.get(k, 0) for k in ("K4", "K5", "K6"))
    took = dict(zip(TILES, (a - b for a, b in zip(tile_launches(), tiles))))
    check(took[TMA_TILE] == n_long,
          f"{name}: {n_long} K4/K5/K6 launches, tiles launched {took}")
    log(name, f"all {n_long} K4/K5/K6 launches of the {n_queries} "
        f"queries took {TMA_TILE}")

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
    # each attention kernel's share of the profiled device time
    shares = {k: v / busy for k, v in split.items()
              if k.startswith("K") and v > 0 and busy > 0}
    log(name, f"VoxelTokenMemory(Config()) over {N_FRAMES} frames "
        f"({int(mem.state.num_voxels)} voxels): voxel_localized("
        f"{TEXT_PROMPT!r}) ms {[round(t, 1) for t in query_ms]} (host clock, "
        f"{imagination.num_images} images {side}^2, {imagination.num_steps} "
        f"steps, CFG {imagination.guidance_scale}, top-{cfg.query.top_k} of "
        f"{len(pos)}); launches per query {fmt(want)}; images mean "
        f"{img_stats[0]:.1f} std {img_stats[1]:.1f}; peak device memory "
        f"{peak:.2f} GB")
    if busy == 0:
        log(name, "torch.profiler saw no device kernels: split not measured")
    else:
        log(name, "profiled query, device time by kind (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
            + f"; kernels busy {busy:.1f} of {profiled_ms:.1f} ms host clock "
            f"(idle share {1 - busy / profiled_ms:.3f}); share of the device "
            f"time: " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
            + "; largest of the rest: "
            + ", ".join(f"{k} {v:.1f}" for k, v in top_rest)
            + f"; T5-XXL encode of the two prompts alone {t5_ms:.1f} ms "
            f"(CUDA events)")
    result = {"query_ms": query_ms, "peak_gb": peak,
              "launches_per_query": dict(zip(
                  [f"K{i}" for i in range(1, 9)], want)),
              "image_side": side, "profile_ms": split,
              "profiled_query_ms": profiled_ms, "device_share": shares,
              "profile_top_rest": top_rest, "t5_encode_ms": t5_ms,
              "num_voxels": int(mem.state.num_voxels)}
    del mem, perception, params
    torch.cuda.empty_cache()
    return result


def phase_textq_all(dev, cfg, vcfg, world, seed):
    """The text-query paths from one set of random bf16 weights, each with
    the launch counts set to 0 just before it and read just after:
    SD3.5-medium at 512^2 in bf16 (K4), SD3-medium at 512^2 (no qk-norm:
    K5), SD3.5-medium at 1024^2 (a 4685-token joint sequence: K6; the dual
    self-attention at 4096 tokens: K4), then SD3.5-medium at 512^2 with
    the MMDiT token matmuls in W8A8 and T5-XXL quantized on the host.
    Returns (results, {path: K1-K8 counts}, the bf16 weights, which the
    robot phase's imagination reuses)."""
    from bsc_nav_tpu_torch.models import mmdit as M
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
    sd35, steps, paths = M.SD35_MEDIUM, 28, {}
    per_query = {"K4": steps * (sd35.depth + len(sd35.dual_attention_layers))}
    check(per_query == {"K4": 1036}, f"SD3.5-medium 512^2: {per_query}")
    reset_counts()
    out = {"bf16": phase_textq(dev, "textq bf16", cfg, vcfg, world,
                               make_imagination(w, sd35, w["t5"], False, seed),
                               seed, per_query)}
    paths["textq"] = counts()

    # SD3-medium: the original transformer, no qk-norm, no dual attention
    sd3 = dataclasses.replace(M.MMDiTConfig(), qk_norm=False)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    w3 = dict(w, mmdit=M.init_params(sd3, gen, torch.bfloat16, dev))
    fill_zero_mods(w3["mmdit"], gen)
    log("textq sd3-medium", f"SD3-medium MMDiT (24 x 1536, no qk-norm, no "
        f"dual attention) {n_params(w3['mmdit']) / 1e9:.3f} G parameters, "
        f"random bf16; the other towers as above")
    per_query = {"K5": steps * sd3.depth}
    check(per_query == {"K5": 672}, f"SD3-medium 512^2: {per_query}")
    reset_counts()
    out["sd3-medium"] = phase_textq(
        dev, "textq sd3-medium", cfg, vcfg, world,
        make_imagination(w3, sd3, w["t5"], False, seed), seed, per_query)
    paths["textq-sd3-medium"] = counts()
    del w3
    torch.cuda.empty_cache()

    # SD3.5-medium at its published 1024^2: the same weights with a
    # position embedding for the 64^2 patch grid
    big = dataclasses.replace(sd35, input_size=128)
    wb = dict(w, mmdit=dict(w["mmdit"], pos_embed=(torch.randn(
        (1, big.num_patches, big.dim), generator=gen, device=dev)
        * 0.01).to(torch.bfloat16)))
    per_query = {"K4": steps * len(big.dual_attention_layers),
                 "K6": steps * big.depth}
    check(per_query == {"K4": 364, "K6": 672},
          f"SD3.5-medium 1024^2: {per_query}")
    reset_counts()
    out["sd35-1024"] = phase_textq(
        dev, "textq sd35-1024", cfg, vcfg, world,
        make_imagination(wb, big, w["t5"], False, seed), seed, per_query,
        n_queries=1)
    paths["textq-sd35-1024"] = counts()
    del wb
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    host = tree_map(lambda t: t.float().cpu().numpy(), w["t5"])
    t1 = time.perf_counter()
    t5_q = t5_from_jax_params(T5.quantize_params_host(host), T5.T5_XXL,
                              dtype=torch.bfloat16, device=dev)
    del host
    torch.cuda.synchronize()
    log("textq int8", f"T5-XXL to the host {t1 - t0:.1f} s, "
        f"quantize_params_host + upload {time.perf_counter() - t1:.1f} s")
    reset_counts()
    out["int8"] = phase_textq(dev, "textq int8", cfg, vcfg, world,
                              make_imagination(w, sd35, t5_q, True, seed),
                              seed, {"K4": 1036}, n_queries=1)
    paths["textq"] = tuple(a + b for a, b in zip(paths["textq"], counts()))
    del t5_q
    torch.cuda.empty_cache()
    return out, paths, w


def phase_textq_parity(dev, seed):
    """A small imagination on the card (K4, K3, cuDNN) against the CPU
    (plain versions), the same weights and injected noise; then the small
    MMDiTs of ``composed_route_parity`` (K5, K6)."""
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
    check(a["launches"] == launches() and b["launches"][3] > 0
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
        f"{fmt(b['launches'])}")
    return {"velocity_err": v_err, "latent_err": l_err, "image_levels": i_err,
            "score_err": s_err, "card_launches": list(b["launches"]),
            **composed_route_parity(dev, seed)}


def composed_route_parity(dev, seed):
    """Two small MMDiTs on the composed joint-attention route, on the card
    (kernels) against the CPU (plain versions): without qk-norm at the
    512^2 latent grid (1024 + 24 joint tokens: K5), and at the 1024^2 grid
    with 32 heads of 16 (4096 + 8 tokens; at B 2 the f32 logits would be
    4.3 GB, past 4e9: K6).  A forward at B 2 and 3 CFG steps at B 1 (the
    same injected noise): velocity and latents."""
    from bsc_nav_tpu_torch.models import mmdit as M

    out = {}
    for name, kernel, S_ctx, mcfg in (
            ("no-qk-norm", "K5", 24, M.MMDiTConfig(
                input_size=64, patch_size=2, in_channels=4, dim=128, depth=2,
                heads=2, context_dim=128, pooled_dim=16, qk_norm=False)),
            ("long", "K6", 8, M.MMDiTConfig(
                input_size=128, patch_size=2, in_channels=4, dim=512,
                depth=1, heads=32, context_dim=128, pooled_dim=16))):
        gen = torch.Generator().manual_seed(seed)
        cpu = M.init_params(mcfg, gen, device="cpu")
        fill_zero_mods(cpu, gen)
        card = tree_map(lambda t: t.to(dev), cpu)
        rng = np.random.default_rng(seed)
        n = mcfg.input_size
        lat, noise = (torch.from_numpy(rng.normal(
            size=(b, n, n, mcfg.in_channels)).astype(np.float32))
            for b in (2, 1))
        t = torch.from_numpy(rng.uniform(0.1, 1, size=2).astype(np.float32))
        ctx = torch.from_numpy(rng.normal(size=(2, S_ctx, 128)).astype(
            np.float32))
        pooled = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
        res = {}
        for d, w in (("cpu", cpu), (dev, card)):
            before = counts()
            vel = M.forward(w, lat.to(d), t.to(d), ctx.to(d), pooled.to(d),
                            mcfg)
            lat3 = M.sample(w, ctx[:1].to(d), pooled[:1].to(d), mcfg,
                            num_steps=3, guidance_scale=4.0,
                            context_uncond=ctx[1:].to(d),
                            pooled_uncond=pooled[1:].to(d), noise=noise.to(d))
            res[str(d)] = (vel.cpu().numpy(), lat3.cpu().numpy(),
                           since(before))
        (va, la, ca), (vb, lb, cb) = res["cpu"], res[str(dev)]
        want = launches(**{kernel: 4 * mcfg.depth})   # 1 forward + 3 steps
        check(ca == launches() and cb == want,
              f"textq-parity {name}: card launches {fmt(cb)}, want "
              f"{fmt(want)}")
        v_err = float(np.abs(va - vb).max())
        l_err = float(np.abs(la - lb).max())
        check(float(np.abs(va).max()) > 0.5, f"textq-parity {name}: zero "
              "velocity")
        check(v_err <= TEXTQ_V_TOL and l_err <= TEXTQ_LAT_TOL,
              f"textq-parity {name}: velocity err {v_err}, latents {l_err}")
        S = mcfg.num_patches + S_ctx
        log("textq-parity", f"MMDiT {name} ({mcfg.depth} x {mcfg.dim}, "
            f"{mcfg.heads} heads of {mcfg.head_dim}, qk_norm "
            f"{mcfg.qk_norm}, {S} joint tokens): velocity err {v_err:.3g} "
            f"(tol {TEXTQ_V_TOL}), latents after 3 CFG steps {l_err:.3g} "
            f"(tol {TEXTQ_LAT_TOL}); card launches {kernel} "
            f"{cb[int(kernel[1]) - 1]}")
        out[name] = {"joint_tokens": S, "velocity_err": v_err,
                     "latent_err": l_err, "card_launches": list(cb)}
        del cpu, card
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phases: the surprise policy, forgetting, the segmented store, exploration
# ---------------------------------------------------------------------------

def recording(perception):
    """Wrap a Perception's build step so that each call's ingest stats are
    kept (the flushes' valid, cached and new points); returns the list."""
    stats, build = [], perception.build_step

    def build_step(*a, **k):
        carry, st = build(*a, **k)
        stats.append({n: int(v) for n, v in st.items()})
        return carry, st

    perception.build_step = build_step
    return stats


def timed_flushes(mem, frames, name, depth, extra=None):
    """Push ``frames`` in flushes of BATCH; each flush's ms (host clock to
    a synchronize) and its launches (K1 +depth, and ``extra``)."""
    ms = []
    for i in range(0, len(frames), BATCH):
        before = counts()
        t0 = time.perf_counter()
        for obs, pose in frames[i:i + BATCH]:
            mem.push_frame(obs, pose)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        want = launches(K1=depth, **(extra or {}))
        check(since(before) == want,
              f"{name} flush {i // BATCH}: {fmt(since(before))} (want "
              f"{fmt(want)})")
    return ms


def phase_surprise(dev, cfg, vcfg, world, params, dist_flush_ms):
    """The default Config() with replacement="surprise" (mean-field gate):
    the 32 frames into an f32 store beside a random-init ViT-L, then the
    first 8 frames again (every point of a known voxel judged) in mean-field
    mode and frames 8-15 again in exact mode (every cached neighbour token,
    in chunks of 512 points); 3 image queries.  Checks: feat_sum and
    feat_obs sized [V1, D] / [V1], feat_obs summing to the valid points,
    counts <= K; prints the flushes beside the dist policy's."""
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)

    env, frames, queries = world
    m = dataclasses.replace(cfg.memory, replacement="surprise")
    scfg = cfg.replace(memory=m)
    perception = Perception.create(scfg, vit_params=params, batch_size=BATCH,
                                   device=dev)
    stats = recording(perception)
    mem = VoxelTokenMemory(scfg, env, perception)
    V1 = mem.state.feat_count.shape[0]
    check(tuple(mem.state.feat_sum.shape) == (V1, m.token_dim)
          and tuple(mem.state.feat_obs.shape) == (V1,),
          "surprise: feat_sum / feat_obs not sized [V1, D] / [V1]")
    flush_ms = timed_flushes(mem, frames, "surprise", vcfg.depth)
    again_ms = timed_flushes(mem, frames[:BATCH], "surprise", vcfg.depth)
    mean_stats = list(stats)
    exact = Perception.create(
        scfg.replace(memory=dataclasses.replace(m, surprise_exact=True)),
        vit_params=params, batch_size=BATCH, device=dev)
    exact_stats = recording(exact)
    mem.perception = exact
    exact_ms = timed_flushes(mem, frames[BATCH:2 * BATCH], "surprise exact",
                             vcfg.depth)
    valid = sum(s["points_valid"] for s in mean_stats + exact_stats)
    obs_sum = float(mem.state.feat_obs.sum())
    check(obs_sum == valid, f"surprise: feat_obs sums to {obs_sum}, "
          f"{valid} valid points")
    K = m.cache_size
    check(int(mem.state.feat_count.max()) <= K, "surprise: a count past K")
    nv = int(mem.state.num_voxels)
    check(int(mem.state.feat_count[:nv].min()) >= 1, "surprise: empty voxel")
    gated = {k: 1.0 - sum(s["points_cached"] for s in ss)
             / max(1, sum(s["points_valid"] for s in ss))
             for k, ss in (("32 frames", mean_stats[:4]),
                           ("again, mean-field", mean_stats[4:]),
                           ("again, exact", exact_stats))}
    query_ms = []
    for i, imgs in enumerate(queries):
        before = counts()
        t0 = time.perf_counter()
        b, pos, sims = mem.voxel_localized(imgs, K=cfg.query.top_k)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        check(since(before) == launches(K1=vcfg.depth, K2=1),
              f"surprise query {i}: {fmt(since(before))}")
        check(len(pos) > 0 and bool(np.isfinite(sims).all())
              and bool((np.diff(sims) <= 0).all()),
              f"surprise query {i}: bad top-K")
    rows = int(mem.state.feat_count.sum())
    ingest = ingest_alone(dev, cfg, scfg, vcfg, mem.state, frames[:BATCH])
    dist_steady = statistics.median(dist_flush_ms[1:])
    out = {"num_voxels": nv, "flush_ms": flush_ms, "ingest_alone": ingest,
           "steady_ms": statistics.median(flush_ms[1:]),
           "again_mean_field_ms": again_ms[0], "again_exact_ms": exact_ms[0],
           "dist_steady_ms": dist_steady, "gated_share": gated,
           "valid_points": valid, "rows": rows,
           "query_ms": query_ms}
    log("surprise", f"Config() f32 store, mean-field gate: {nv} voxels, "
        f"{out['rows']:,} rows; flush ms {[round(t, 2) for t in flush_ms]}, "
        f"steady {out['steady_ms']:.2f} against the dist policy's "
        f"{dist_steady:.2f} (slice f32, this process); frames 0-7 again "
        f"{again_ms[0]:.2f} ms mean-field, frames 8-15 again "
        f"{exact_ms[0]:.2f} ms exact; share of valid points gated out "
        f"{ {k: round(v, 4) for k, v in gated.items()} }; feat_obs sums to "
        f"the {valid:,} valid points; counts <= {K}; query ms "
        f"{[round(t, 2) for t in query_ms]}")
    log("surprise", "the ingest alone of 8 frames into this store (random "
        "patch tokens; host clock to a synchronize, median of 3 each): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in ingest.items()))
    del mem, perception, exact
    torch.cuda.empty_cache()
    return out


def ingest_alone(dev, cfg, scfg, vcfg, state, frames) -> dict:
    """ms of ``ingest_frames`` alone for one batch into ``state`` under
    the dist policy, the mean-field and the exact gate (median of 3, host
    clock to a synchronize), and of the mean-field gate's neighbour norm
    (``fma_norm``, an FMA chain of D steps) on its [N, 26, D] means."""
    from bsc_nav_tpu_torch.memory.ingest import (
        fma_norm, ingest_frames, points_per_frame)

    gen = torch.Generator(device=dev).manual_seed(1)
    rgb, depth, poses = (torch.from_numpy(np.stack(a)).to(dev) for a in (
        [o["rgb"][:, :, :3] for o, _ in frames],
        [o["depth"] for o, _ in frames], [p for _, p in frames]))
    g = cfg.query.query_height // vcfg.patch_size
    tokens = torch.randn(len(frames), g, g, cfg.memory.token_dim,
                         generator=gen, device=dev)
    exact = scfg.replace(memory=dataclasses.replace(scfg.memory,
                                                    surprise_exact=True))
    out = {}
    for name, c in (("dist", cfg), ("mean-field", scfg), ("exact", exact)):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ingest_frames(state, rgb, depth, poses, tokens, gen, c)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(ts)
    means = torch.randn(len(frames) * points_per_frame(cfg), 26,
                        cfg.memory.token_dim, generator=gen, device=dev)
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fma_norm(means)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    out["fma_norm"] = statistics.median(ts)
    return out


def forget_case(name, state) -> dict:
    """forgetting_pass on a store at full capacity, twice (in place):
    ms, voxels and rows before and after; rows past every count zero-norm
    (int8: scale 1.0), no voxel emptied, counts <= K.  It launches no
    kernel of the list."""
    from bsc_nav_tpu_torch.memory.replacement import forgetting_pass

    V1 = state.feat_count.shape[0]
    K = state.feats.shape[0] // V1
    cnt = state.feat_count
    out = {"store": name, "V1": V1, "voxels_before": int((cnt > 0).sum()),
           "rows_before": int(cnt.sum()), "ms": []}
    before = counts()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forgetting_pass(state)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    check(since(before) == launches(), f"forget {name}: {fmt(since(before))}")
    cnt = state.feat_count
    out["voxels_after"] = int((cnt > 0).sum())
    out["rows_after"] = int(cnt.sum())
    check(out["voxels_after"] == out["voxels_before"],
          f"forget {name}: a voxel emptied")
    check(out["rows_after"] <= out["rows_before"] and int(cnt.max()) <= K,
          f"forget {name}: rows grew")
    dead = (torch.arange(K, device=cnt.device)[None, :]
            >= cnt[:, None]).reshape(-1)
    check(float(state.feat_norm[dead].abs().max()) == 0.0,
          f"forget {name}: a row past its count kept its norm")
    if state.feats.dtype == torch.int8:
        check(bool((state.feat_scale[dead] == 1.0).all()),
              f"forget {name}: a scale past a count is not 1.0")
    return out


def synthetic_full_store(cfg, dev, gen, n):
    """The default store with n live voxels of 1-10 random f32 rows each
    (distinct positions, a filled slot map) -- a scene that fills 0.95 of
    the capacity, without ingesting 13 x the 32 frames."""
    from bsc_nav_tpu_torch.memory.store import init_store

    m = cfg.memory
    K, D, G, H = m.cache_size, m.token_dim, m.grid_size, m.num_height_cells
    st = init_store(m, torch.float32, device=dev)
    cnt = torch.randint(1, K + 1, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    st.feat_count[:n] = cnt
    live = (torch.arange(K, device=dev)[None, :] < cnt[:, None]).reshape(-1)
    for r0 in range(0, n * K, 1 << 18):
        r1 = min(n * K, r0 + (1 << 18))
        f = torch.randn(r1 - r0, D, generator=gen, device=dev)
        f *= live[r0:r1, None]
        st.feats[r0:r1] = f
        st.feat_norm[r0:r1] = f.norm(dim=1)
    stride = G * G * H // n
    lin = torch.arange(n, device=dev) * stride
    st.slot_pos[:n] = torch.stack([lin // (G * H), (lin // H) % G, lin % H],
                                  dim=1).to(torch.int32)
    st.slot_map[lin] = torch.arange(n, dtype=torch.int32, device=dev)
    st.num_voxels.fill_(n)
    st.initialized.fill_(True)
    return st


def phase_segments(dev, cfg, vcfg, world, params, spine_pos, seed):
    """VoxelTokenMemory(segmented=True, max_device_segments=1) at the
    default Config()'s width and K, voxel_capacity cut to 4,096 so that
    the 32 frames rotate several times: segments, spills, the positions
    across segments against the plain f32 store's; 3 image queries and a
    3-radius voxel_localized_batch, K2 on the active segment and K2b at
    Q 1 on each int8 segment, device or spilled.  Then at the full
    capacity: a store of 0.95 x 131,072 live voxels frozen to int8 (the
    rotation timed), a query on it on the card, its spill to pinned host
    memory (D2H GB/s; pageable beside it) and a query on the spilled
    segment (H2D GB/s + K2b)."""
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.memory import query as Q
    from bsc_nav_tpu_torch.memory import segments as S
    from bsc_nav_tpu_torch.memory.store import store_nbytes

    env, frames, queries = world
    scfg = cfg.replace(memory=dataclasses.replace(
        cfg.memory, voxel_capacity=SEGMENT_CAPACITY))
    perception = Perception.create(scfg, vit_params=params,
                                   batch_size=BATCH, device=dev)
    stats = recording(perception)
    mem = VoxelTokenMemory(scfg, env, perception, segmented=True,
                           max_device_segments=1)
    flush_ms = timed_flushes(mem, frames, "segments", vcfg.depth)
    seg = mem.segments
    n_seg, n_dev, n_host = (seg.num_segments, len(seg.device_segments),
                            len(seg.host_segments))
    check(n_seg >= 3 and n_host >= 1,
          f"segments: {n_seg} segments, {n_host} spilled")
    check(all(s.feats.dtype == torch.int8 for s in seg.device_segments)
          and all(h["feats"].dtype == torch.int8 for h in seg.host_segments)
          and all(h["feats"].is_pinned() for h in seg.host_segments),
          "segments: a frozen segment is not int8 (or a spill not pinned)")
    total = seg.total_voxels()
    new = sum(s["new_voxels"] for s in stats)
    dropped = new - total            # new voxels past a segment's capacity
    pos = [s_.slot_pos[:int(s_.num_voxels)].cpu().numpy()
           for s_ in [seg.state] + seg.device_segments]
    pos += [h["slot_pos"].numpy() for h in seg.host_segments]
    union = set(map(tuple, np.concatenate(pos).tolist()))
    plain = set(map(tuple, spine_pos.tolist()))
    check(total == sum(len(p) for p in pos), "segments: voxel totals")
    check(union <= plain, "segments: a voxel the plain store does not hold")
    check(dropped > 0 or union == plain,
          "segments: no voxel dropped, yet positions differ from the plain "
          "store's")
    k2b_per_query = n_seg - 1
    query_ms, best = [], None
    for i, imgs in enumerate(queries):
        before = counts()
        t0 = time.perf_counter()
        b, p_, sims = mem.voxel_localized(imgs, K=cfg.query.top_k)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        want = launches(K1=vcfg.depth, K2=1, K2b=k2b_per_query)
        check(since(before) == want, f"segments query {i}: "
              f"{fmt(since(before))} (want {fmt(want)})")
        check(len(p_) > 0 and bool((np.diff(sims) <= 0).all())
              and len(set(map(tuple, p_.tolist()))) == len(p_),
              f"segments query {i}: bad merged top-K")
        best = b[0] if best is None else best
    radii = [30.0, 40.0, 50.0]
    before = counts()
    t0 = time.perf_counter()
    batch = mem.voxel_localized_batch([queries[0]] * 3, K=cfg.query.top_k,
                                      region_radii=radii, curr_grid=best)
    batch_ms = (time.perf_counter() - t0) * 1e3
    want = launches(K1=vcfg.depth, K2=3, K2b=3 * k2b_per_query)
    check(since(before) == want,
          f"segments batch: {fmt(since(before))} (want {fmt(want)})")
    for r, (_, p_, _) in zip(radii, batch):
        check(len(p_) > 0 and bool((((p_ - best) ** 2).sum(1)
                                    <= r * r).all()),
              f"segments batch: a voxel outside r {r}")
    path = counts()
    out = {"capacity": SEGMENT_CAPACITY, "segments": n_seg, "device": n_dev,
           "spilled": n_host, "total_voxels": total, "new_voxels": new,
           "dropped": dropped, "distinct_positions": len(union),
           "plain_voxels": len(plain), "flush_ms": flush_ms,
           "query_ms": query_ms, "batch3_ms": batch_ms}
    log("segments", f"Config() at width and K, voxel_capacity 4,096 (cut): "
        f"{n_seg} segments ({n_dev} int8 on the card, {n_host} spilled), "
        f"{total:,} voxels ({len(union):,} distinct positions of the plain "
        f"store's {len(plain):,}; {dropped:,} new voxels past a "
        f"segment's capacity); flush ms {[round(t, 2) for t in flush_ms]}; "
        f"query ms {[round(t, 2) for t in query_ms]} (K2 +1, K2b "
        f"+{k2b_per_query} each), 3-radius batch {batch_ms:.2f} ms")
    del mem, perception, seg
    torch.cuda.empty_cache()

    # --- the full capacity -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    m = cfg.memory
    K, D = m.cache_size, m.token_dim
    full = S.SegmentedStore(m, max_device_segments=1, device=dev)
    n = full.rotate_threshold
    full.state = synthetic_full_store(cfg, dev, gen, n)
    forget_full = forget_case("full f32", full.state)
    q = torch.randn(D, generator=gen, device=dev)
    qn = q / q.norm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(full.rotate_if_full(), "segments: the full store did not rotate")
    torch.cuda.synchronize()
    rotate_ms = (time.perf_counter() - t0) * 1e3
    frozen = full.device_segments[0]
    check(frozen.feats.dtype == torch.int8, "segments: not frozen to int8")

    def device_query():
        return Q.localize(frozen, q, top_k=cfg.query.top_k)[1].cpu()

    before = counts()
    device_query()
    check(since(before) == launches(K2b=1), "segments: device segment "
          f"query launched {fmt(since(before))}")
    dev_ms = [cuda_ms(device_query, reps=5, warmup=1)]
    rows = n * K
    feat_bytes = rows * D
    seg_bytes = rows * (D + 4) + n * 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = S.spill(frozen)
    spill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()            # the copy alone, buffers pinned
    host["feats"].copy_(frozen.feats[:rows])
    pinned_d2h_ms = (time.perf_counter() - t0) * 1e3
    pageable = torch.empty(rows, D, dtype=torch.int8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pageable.copy_(frozen.feats[:rows])
    pageable_d2h_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.equal(pageable, host["feats"])),
          "segments: the spilled rows differ from the card's")
    del pageable
    full.device_segments.clear()
    full.host_segments.append(host)
    del frozen
    torch.cuda.empty_cache()

    def h2d(src):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst = src.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        del dst
        return (time.perf_counter() - t0) * 1e3

    h2d_ms = [h2d(host["feats"]) for _ in range(3)]
    h2d_pageable_ms = h2d(host["feats"].clone())
    before = counts()
    host_ms_ = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hp, hs = full._localize_host_segment(host, qn, cfg.query.top_k)
        host_ms_.append((time.perf_counter() - t0) * 1e3)
    check(since(before) == launches(K2b=3),
          f"segments: spilled query launched {fmt(since(before))}")
    # the streamed scan of the first 16,384 voxels' rows against its plain
    # version on the host rows, within the f32 dot bound
    nv_, rv_ = 16_384, 16_384 * K
    sub = [host["feats"][:rv_], host["feat_norm"][:rv_],
           host["feat_count"][:nv_]]
    with uncounted():
        got = S.max_cosine(*(t.to(dev) for t in sub), qn).cpu()
    ref = S.max_cosine(*sub, qn.cpu())
    qb = qn.cpu().to(torch.bfloat16).float()[None]      # int8: bf16 query
    err = k2_check(got, ref, k2_bound(*sub, qb)[0],
                   "segments: the streamed scan")
    gbs = lambda nbytes, ms: nbytes / ms / 1e6
    full_out = {
        "voxels": n, "rows": rows, "int8_gb": feat_bytes / 1e9,
        "forget": forget_full, "rotate_ms": rotate_ms,
        "device_segment_query_ms": dev_ms[0],
        "spill_ms": spill_ms, "spill_gb_s": gbs(seg_bytes, spill_ms),
        "pinned_d2h_gb_s": gbs(feat_bytes, pinned_d2h_ms),
        "pageable_d2h_gb_s": gbs(feat_bytes, pageable_d2h_ms),
        "h2d_gb_s": [gbs(feat_bytes, t) for t in h2d_ms],
        "pageable_h2d_gb_s": gbs(feat_bytes, h2d_pageable_ms),
        "spilled_query_ms": host_ms_, "streamed_scan_err": err}
    log("segments", f"full capacity: {n:,} voxels ({rows:,} rows, "
        f"{feat_bytes / 1e9:.3f} GB int8 frozen): rotation {rotate_ms:.1f} "
        f"ms (quantize + a fresh {store_nbytes(m) / 1e9:.2f} GB store); a "
        f"query on the device "
        f"segment {dev_ms[0]:.3f} ms (K2b Q 1 + top-100, events); spill "
        f"to pinned memory {spill_ms:.1f} ms ({full_out['spill_gb_s']:.2f} "
        f"GB/s with the pinning; the copy alone "
        f"{full_out['pinned_d2h_gb_s']:.2f}; pageable D2H "
        f"{full_out['pageable_d2h_gb_s']:.2f}); H2D "
        f"pinned {[round(x, 2) for x in full_out['h2d_gb_s']]} GB/s, "
        f"pageable {full_out['pageable_h2d_gb_s']:.2f}; a query on the "
        f"spilled segment {[round(t, 1) for t in host_ms_]} ms (stream + "
        f"K2b + host top-100); streamed scan err {err:.3g}; forgetting_pass "
        f"at full capacity {[round(t, 2) for t in forget_full['ms']]} ms")
    del full, host
    torch.cuda.empty_cache()
    out["full_capacity"] = full_out
    return out, path


def phase_explore(dev, cfg, vcfg, params, seed):
    """exploring_create_memory (random_move_num 3) then
    explore_entire_space (max_iterations 2) on FakeNavEnv at the default
    Config(): steps, flushes, s; the store grows, the frames the flows
    push are flushed, no count past K."""
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.env.fake import BoxScene, FakeNavEnv
    from bsc_nav_tpu_torch.env.pathfinding import AgentState, Quat

    ecfg = cfg.replace(agent=dataclasses.replace(cfg.agent,
                                                 random_move_num=3))
    env = FakeNavEnv(ecfg, scene=BoxScene.default(), seed=seed)
    env.reset(init_state=AgentState(np.zeros(3), Quat.from_yaw(0.0)),
              build_map=True)
    perception = Perception.create(ecfg, vit_params=params,
                                   batch_size=BATCH, device=dev)
    stats = recording(perception)
    mem = VoxelTokenMemory(ecfg, env, perception)
    out = {}
    for flow, run in (("exploring_create_memory",
                       lambda: mem.exploring_create_memory(save=False)),
                      ("explore_entire_space",
                       lambda: mem.explore_entire_space(max_iterations=2,
                                                        save=False))):
        steps0, flushes0, before = mem.step_count, len(stats), counts()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        flushes = len(stats) - flushes0
        check(since(before) == launches(K1=vcfg.depth * flushes),
              f"explore {flow}: {fmt(since(before))}")
        out[flow] = {"steps": mem.step_count - steps0, "flushes": flushes,
                     "s": s, "num_voxels": int(mem.state.num_voxels)}
    check(out["exploring_create_memory"]["steps"] > 0
          and out["explore_entire_space"]["steps"] > 0,
          "explore: no steps taken")
    check(out["explore_entire_space"]["num_voxels"]
          >= out["exploring_create_memory"]["num_voxels"] > 0,
          "explore: an empty store")
    check(not mem._queue and int(mem.state.feat_count.max())
          <= cfg.memory.cache_size, "explore: unflushed frames or counts")
    log("explore", "; ".join(
        f"{k}: {v['steps']} steps, {v['flushes']} flushes, {v['s']:.1f} s, "
        f"{v['num_voxels']} voxels" for k, v in out.items())
        + f" (FakeNavEnv renders each {cfg.sensor.width}x"
        f"{cfg.sensor.height} frame on the host; "
        f"{len(mem.base_height)} heights recorded)")
    del mem, perception
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases: the robots and the episode drivers
# ---------------------------------------------------------------------------

ROBOT_PARITY_TOL = 1e-4   # top-K scores, the drivers' tiny ViT, card vs CPU
ROBOT_BUILD_MOVES = 3     # waypoints of the full-width memory build


def build_tmp():
    """A temporary directory under the repository's build/."""
    import tempfile

    from bsc_nav_tpu_torch.ops import _build
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent)


def driver_args(argv):
    """The drivers' parsed arguments (drivers/setup.add_common_args)."""
    from bsc_nav_tpu_torch.drivers import setup as DS
    p = argparse.ArgumentParser()
    DS.add_common_args(p)
    return p.parse_args(argv)


def same_draws(perception, cfg, draws, rng):
    """The n-th build step takes ``draws[n]``, the pixel and replacement
    draws made once from ``rng``: a card and a CPU memory that share
    ``draws`` ingest the same points."""
    from bsc_nav_tpu_torch.memory.ingest import points_per_frame
    H, W = cfg.sensor.height, cfg.sensor.width
    P, K = points_per_frame(cfg), cfg.memory.cache_size
    build, calls = perception.build_step, [0]

    def build_step(c, params, rgb, depth, poses):
        i, B, d = calls[0], rgb.shape[0], rgb.device
        calls[0] += 1
        while len(draws) <= i:
            draws.append((rng.integers(0, H * W, (B, P)),
                          rng.integers(0, K, B * P)))
        pix, repl = draws[i]
        return build(c, params, rgb, depth, poses,
                     pix=torch.from_numpy(pix).to(d),
                     repl_idx=torch.from_numpy(repl).to(d))

    perception.build_step = build_step


def recorded_queries(mem):
    """Wrap ``voxel_localized`` so that each result is kept; returns the
    list."""
    out, query = [], mem.voxel_localized

    def voxel_localized(*a, **k):
        res = query(*a, **k)
        out.append(res)
        return res

    mem.voxel_localized = voxel_localized
    return out


def query_margin(a, b, tol, qcfg):
    """Two top-K results (CPU, card) of equal stores: the sorted scores must
    agree within ``tol`` (raises otherwise).  Returns (max score error,
    the same voxels in the same order, the decisions' margin: the
    smallest gap between distinct scores of the CPU's top-K (its order
    and boundary), and between the mean scores of its clusters (their
    order as candidates) -- a decision within ``tol`` could flip)."""
    from bsc_nav_tpu_torch.agents.clustering import weighted_cluster_centers
    (pa, sa), (pb, sb) = live_tops(a), live_tops(b)
    check(len(sa) == len(sb), f"robot-parity: {len(sa)} / {len(sb)} live")
    err = float(np.abs(np.sort(sa) - np.sort(sb)).max()) if len(sa) else 0.0
    check(err <= tol, f"robot-parity: query score err {err} > {tol}")
    _, labels, _ = weighted_cluster_centers(
        pa, sa, eps=qcfg.cluster_eps, min_samples=qcfg.cluster_min_samples)
    means = [sa[labels == lb].mean() for lb in set(labels) - {-1}]
    gaps = np.r_[np.diff(np.unique(sa)), np.diff(np.sort(means))]
    return err, bool(np.array_equal(pa, pb)), float(
        gaps.min() if len(gaps) else np.inf)


def phase_robot_parity(dev, seed):
    """The drivers' fake world (drivers/setup.build_world: 64x64 frames, a
    tiny ViT) on the CPU and on the card in one process, the card's encoder
    holding the CPU one's weights and both builds the same draws: objnav
    through drivers.common.run_episodes for two episodes, the first on the
    long-term memory path, the second on the working-memory path.  Where
    stage 1 decides, the actions, nav_log and CSV row must be equal; the
    working-memory queries are held to ROBOT_PARITY_TOL, and where a top-K
    decision lies within it, its margin is reported instead."""
    from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot
    from bsc_nav_tpu_torch.drivers import common as DC
    from bsc_nav_tpu_torch.drivers import setup as DS

    runs, params, draws = [], None, []
    rng = np.random.default_rng(seed + 7)
    with build_tmp() as tmp:
        for i, d in enumerate(("cpu", dev)):
            root = os.path.join(tmp, f"run{i}")
            args = driver_args(["--device", str(d), "--seed", str(seed),
                                "--memory-root", root])
            cfg, bench, mem, extras = DS.build_world(args, "objnav")
            if params is None:
                params = mem.perception.vit_params.state_dict()
            else:
                mem.perception.vit_params.load_state_dict(params)
            same_draws(mem.perception, cfg, draws, rng)
            queries = recorded_queries(mem)
            robot = ObjectNavRobot(mem, bench, llm_client=extras["llm"],
                                   matcher=extras["matcher"])
            episodes = []

            def episode_fn(r, ep, cfg=cfg, mem=mem, bench=bench):
                mem.cfg = cfg.replace(agent=dataclasses.replace(
                    cfg.agent, use_only_working_memory=bench._ep_idx == 1))
                r.move2textprompt(f"a {ep.object_category}")
                mem.cfg = cfg

            def metrics_fn(r, b, ep, episodes=episodes):
                m = b.get_metrics()
                island, area = DS.island_stats(b)
                episodes.append((list(r.action_hist), dict(r.nav_log),
                                 json.loads(json.dumps(r.loc_hist))))
                return {"success": m["success"], "spl": m["spl"],
                        "distance_to_goal": m["distance_to_goal"],
                        "object_goal": ep.object_category, "id": ep.scene_id,
                        "island": island, "island_area": area,
                        **DC.nav_telemetry(r)}

            csv_path = os.path.join(root, "r.csv")
            before = counts()
            t0 = time.perf_counter()
            DC.run_episodes(robot, bench, 2, episode_fn, metrics_fn, csv_path,
                            log_root=os.path.join(root, "tmp"),
                            ensure_memory=DS.ensure_memory_fake)
            runs.append(dict(
                episodes=episodes, rows=open(csv_path).read().splitlines(),
                queries=queries, state=mem.state, launched=since(before),
                s=time.perf_counter() - t0))
    cpu, card = runs
    path = card["launched"]
    # the drivers' ViT has head_dim 16: K3 carries it, as in JAX
    check(all((path[i] > 0) == (i in (1, 2)) for i in range(9)),
          f"robot-parity launches {fmt(path)} (want K2, K3 only)")
    check(cpu["episodes"][0][1]["working_memory_query"] == 0
          < cpu["episodes"][0][1]["long_memory_query"],
          "robot-parity: stage 1 did not decide episode 0")
    check(card["episodes"][0] == cpu["episodes"][0]
          and card["rows"][:2] == cpu["rows"][:2],
          "robot-parity: the stage-1 episode differs, card vs CPU")
    n = int(cpu["state"].num_voxels)
    store_equal = all(torch.equal(getattr(cpu["state"], f)[:n],
                                  getattr(card["state"], f)[:n].cpu())
                      for f in ("slot_pos", "feat_count"))
    check(len(cpu["queries"]) == len(card["queries"]) >= 1,
          "robot-parity: the working-memory episode made no query")
    out = {"voxels": n, "store_equal": store_equal, "queries": []}
    (ca, cn, cl), (ga, gn, gl) = cpu["episodes"][1], card["episodes"][1]
    wm_equal = ca == ga and cn == gn and cpu["rows"][2] == card["rows"][2]
    for a, b in zip(cpu["queries"], card["queries"]):
        err, same, margin = query_margin(a, b, ROBOT_PARITY_TOL, cfg.query)
        out["queries"].append({"score_err": err, "same_voxels": same,
                               "margin": margin})
    # the candidates are score-weighted centres: within the scores' error
    # of each other, not equal
    cw, gw = (np.asarray(h["working_memory"], float) for h in (cl, gl))
    loc_err = (float(np.abs(cw - gw).max()) if cw.shape == gw.shape
               and cw.size else (0.0 if cw.shape == gw.shape else np.inf))
    settled = store_equal and all(q["same_voxels"]
                                  and q["margin"] > ROBOT_PARITY_TOL
                                  for q in out["queries"])
    # a settled query (equal store and voxels, every score and cluster
    # mean farther apart than the bound) leaves nothing to flip
    check(not settled or (wm_equal and loc_err <= ROBOT_PARITY_TOL),
          f"robot-parity: the working-memory episode differs with every "
          f"decision settled (same walk {wm_equal}, candidates "
          f"{loc_err:.3g} cells apart)")
    out.update(wm_episode_equal=wm_equal, candidates_err=loc_err,
               settled=settled,
               steps=[len(e[0]) for e in cpu["episodes"]],
               cpu_s=cpu["s"], card_s=card["s"])
    log("robot-parity", f"the drivers' fake world ({n} voxels, store "
        f"{'equal' if store_equal else 'NOT equal'} card vs CPU): episode 0 "
        f"(stage 1, {out['steps'][0]} steps) equal; episode 1 (working "
        f"memory, {out['steps'][1]} steps) "
        f"{'equal' if wm_equal else 'differs'} (candidates "
        f"{loc_err:.3g} cells apart); queries "
        + "; ".join(f"score err {q['score_err']:.3g}, same voxels "
                    f"{q['same_voxels']}, margin {q['margin']:.3g} (bound "
                    f"{ROBOT_PARITY_TOL})" for q in out["queries"])
        + f"; CPU {cpu['s']:.1f} s, card {card['s']:.1f} s")
    return out, path


def scripted_llm(DS, args, bench, stage):
    """The drivers' mock LLM with the VLM judge scripted: 'no' on the
    long-term memory's candidates, so that move2textprompt goes on to the
    prefetched stage 2, and 'yes' on the first candidate of any other
    stage (random weights make the true-distance oracle meaningless, and
    each failed candidate costs two 12-view turns of host rendering)."""
    llm = DS.make_llm(args, bench)

    def judge(text):
        if stage["key"] == "long_memory":
            return "Success: no\nnot the goal"
        return "Success: yes\nneed forward: no"

    llm.responders[0] = (llm.responders[0][0], judge)
    return llm


def phase_robot(dev, cfg, world, w, seed):
    """The robots at full width: Config() with FakeBenchmarkEnv over
    BoxScene.default() at 680x680, wired as the JAX package's habitat
    world is (minus habitat): Perception with bf16 compute and a random
    ViT-L/14-reg over the f32 131,080 x 10 x 1024 store, CLIPMatcher on
    MetaCLIP ViT-H/14 at cfg.models.clip_int8, ClipPatchDetector over the
    HM3D classes (threshold at the 99th percentile of the heat random
    towers give, as the clip phase does), DiffusionImagination
    SD3.5-medium 512^2 in bf16 on the text-query phases' weights, and the
    drivers' mock LLM with a scripted judge.  The memory is built once as
    ensure_memory_fake builds it (ROBOT_BUILD_MOVES waypoints); then one
    episode each of move2textprompt (objnav: the stage-2 text query
    prefetched while stage 1 walks), move2imgprompt (imagenav) and
    move2VLNprompt (vlnce)."""
    from bsc_nav_tpu_torch.agents.matchers import CLIPMatcher
    from bsc_nav_tpu_torch.agents.robot import ObjectNavRobot
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.config import HM3D_DETECT_CLASSES
    from bsc_nav_tpu_torch.drivers import setup as DS
    from bsc_nav_tpu_torch.env.benchmark import FakeBenchmarkEnv
    from bsc_nav_tpu_torch.env.fake import BoxScene
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import mmdit as M
    from bsc_nav_tpu_torch.models.detector import ClipPatchDetector
    from bsc_nav_tpu_torch.models.tokenizer import default_tokenizer

    rcfg = cfg.replace(agent=dataclasses.replace(
        cfg.agent, random_move_num=ROBOT_BUILD_MOVES))
    scene = BoxScene.default()
    t0 = time.perf_counter()
    imagination = make_imagination(w, M.SD35_MEDIUM, w["t5"], False, seed)
    ccfg = C.CONFIGS[cfg.models.clip]
    clip = C.init_params(ccfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    tok = default_tokenizer()
    matcher = CLIPMatcher(clip, ccfg, tok, quantize=cfg.models.clip_int8,
                          device=dev)
    det = ClipPatchDetector(clip, ccfg, tok, list(HM3D_DETECT_CLASSES),
                            confidence=cfg.detector.confidence, device=dev)
    _, frames, _ = world
    sims = np.concatenate([
        det.embed(np.stack([o["rgb"] for o, _ in frames[i:i + BATCH]]))
        for i in range(0, N_FRAMES, BATCH)]) @ det.text_emb.T * 100.0
    p = np.exp(sims - sims.max(axis=-1, keepdims=True))
    det.confidence = float(np.percentile(
        (p / p.sum(axis=-1, keepdims=True)).max(axis=-1), 99))
    episodes = DS.fake_episodes(scene, "vlnce", seed)
    bench = FakeBenchmarkEnv(rcfg, episodes, scene=scene, seed=seed,
                             success_distance=rcfg.sim.success_distance)
    perception = Perception.create(rcfg, batch_size=BATCH,
                                   compute_dtype=torch.bfloat16, seed=seed,
                                   device=dev)
    flushes = recording(perception)
    stage, prefetch = {"key": None}, {"dispatched": 0, "consumed": 0}
    render = {"s": 0.0, "frames": 0}
    draw = bench.nav_env._renderer.render

    def timed_render(*a, **k):
        t = time.perf_counter()
        out = draw(*a, **k)
        render["s"] += time.perf_counter() - t
        render["frames"] += 1
        return out

    bench.nav_env._renderer.render = timed_render
    out = {"detector_threshold": det.confidence}
    with build_tmp() as tmp:
        args = driver_args(["--memory-root", tmp, "--seed", str(seed)])
        mem = VoxelTokenMemory(rcfg, env=bench.nav_env,
                               perception=perception, detector=det,
                               imagination=imagination)
        robot = ObjectNavRobot(mem, bench, llm_client=scripted_llm(
            DS, args, bench, stage), matcher=matcher)
        navigate = robot._navigate_candidates

        def staged(best_poses, prompt, max_candidates=3):
            stage["key"] = ("long_memory" if best_poses is not None
                            and best_poses.ndim == 2 else "working_memory")
            return navigate(best_poses, prompt, max_candidates)

        robot._navigate_candidates = staged
        dispatch = mem.voxel_localized_async

        def async_query(*a, **k):
            finish = dispatch(*a, **k)
            prefetch["dispatched"] += finish is not None
            if finish is None:
                return None
            sent = time.perf_counter()

            def consumed():
                prefetch["consumed"] += 1
                prefetch["walk_s"] = time.perf_counter() - sent
                t = time.perf_counter()
                res = finish()
                prefetch["wait_s"] = time.perf_counter() - t
                return res
            return consumed

        mem.voxel_localized_async = async_query
        log("robot", f"set up in {time.perf_counter() - t0:.1f} s: ViT-L "
            f"bf16 compute, f32 store, MetaCLIP ViT-H/14 matcher "
            f"(int8 {cfg.models.clip_int8}) and patch detector "
            f"(threshold {det.confidence:.4f}), SD3.5-medium 512^2 bf16")
        before, renders, t0 = counts(), dict(render), time.perf_counter()
        bench._ep_idx = -1
        obs = bench.reset()
        DS.ensure_memory_fake(robot, bench)
        torch.cuda.synchronize()
        out["build"] = {"s": time.perf_counter() - t0,
                        "steps": mem.step_count, "flushes": len(flushes),
                        "voxels": int(mem.state.num_voxels),
                        "instances": len(mem.long_memory_dict),
                        "render_s": render["s"] - renders["s"],
                        "launches": fmt(since(before))}
        check(out["build"]["voxels"] > 0 and out["build"]["instances"] > 0,
              f"robot: memory build {out['build']}")
        log("robot", f"memory build ({ROBOT_BUILD_MOVES} waypoints): "
            f"{out['build']}")
        goal_img = DS.SceneImagination(rcfg, scene)
        tasks = (("objnav", lambda r, ep: r.move2textprompt(
                      f"a {ep.object_category}")),
                 ("imagenav", lambda r, ep: r.move2imgprompt(
                      goal_img(ep.object_category)[0])),
                 ("vlnce", lambda r, ep: r.move2VLNprompt(ep.instruction)))
        out["episodes"] = []
        for i, (task, run) in enumerate(tasks):
            bench._ep_idx = i - 1
            obs = bench.reset()
            robot.reset(obs, log_dir=os.path.join(tmp, f"trajectory_{i}"))
            stage["key"] = None
            before, renders = counts(), dict(render)
            n_flush, t0 = len(flushes), time.perf_counter()
            run(robot, bench.current_episode)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            m = bench.get_metrics()
            ep = {"task": task, "goal": bench.current_episode.object_category,
                  "s": s, "steps": len(robot.action_hist),
                  "render_s": render["s"] - renders["s"],
                  "frames": render["frames"] - renders["frames"],
                  "flushes": len(flushes) - n_flush,
                  "nav_log": dict(robot.nav_log),
                  "launches": fmt(since(before)),
                  "distance_to_goal": m["distance_to_goal"],
                  "success": m["success"]}
            ep["render_share"] = ep["render_s"] / s
            check(ep["steps"] > 0 and np.isfinite(m["distance_to_goal"])
                  and os.path.exists(os.path.join(
                      tmp, f"trajectory_{i}", "log_data.json")),
                  f"robot {task}: {ep}")
            if task == "objnav":
                ep["prefetch"] = dict(prefetch)
                check(prefetch["dispatched"] == prefetch["consumed"] == 1,
                      f"robot objnav: prefetch {prefetch}")
            log("robot", f"{task} episode ('{ep['goal']}'): {s:.1f} s, "
                f"{ep['steps']} steps, {ep['frames']} frames rendered in "
                f"{ep['render_s']:.1f} s ({ep['render_share']:.2f} of the "
                f"episode), {ep['flushes']} flushes, nav_log "
                f"{ep['nav_log']}, launches {ep['launches']}"
                + (f", prefetch {ep['prefetch']}" if task == "objnav"
                   else ""))
            out["episodes"].append(ep)
    del mem, robot, perception, matcher, det, clip, imagination
    torch.cuda.empty_cache()
    return out


def phase_segments_parity(dev, seed):
    """small_test_config(): the same frames and injected draws on the CPU
    (plain versions) and on the card (kernels): surprise stores in both
    modes, forgetting_pass on the result, and a segmented store's merged
    top-K (K2 and K2b on the card)."""
    from bsc_nav_tpu_torch.config import small_test_config
    from bsc_nav_tpu_torch.memory.ingest import ingest_frames, points_per_frame
    from bsc_nav_tpu_torch.memory.replacement import forgetting_pass
    from bsc_nav_tpu_torch.memory.segments import SegmentedStore
    from bsc_nav_tpu_torch.memory.store import init_store

    base = small_test_config()
    rng = np.random.default_rng(seed + 5)
    B, H, W = 3, base.sensor.height, base.sensor.width
    P, D, K = points_per_frame(base), base.memory.token_dim, \
        base.memory.cache_size
    rgb = rng.integers(0, 255, size=(B, H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0.2, 4.0, size=(B, H, W)).astype(np.float32)
    poses = np.zeros((B, 7), np.float32)
    poses[:, :3] = rng.uniform(-1, 1, size=(B, 3))
    qt = rng.normal(size=(B, 4))
    poses[:, 3:] = qt / np.linalg.norm(qt, axis=1, keepdims=True)
    tokens = rng.normal(size=(B, 2, 2, D)).astype(np.float32)
    batches = [(tokens, rng.integers(0, H * W, size=(B, P)))
               for _ in range(2)]
    batches[1] = (tokens + rng.normal(size=tokens.shape).astype(np.float32),
                  batches[1][1])
    G = base.memory.grid_size
    ints = (("slot_pos", -2), ("feat_count", -2), ("slot_map", -1),
            ("cv_map", G * G), ("max_height", G * G), ("num_voxels", None))
    out = {}
    for exact in (False, True):
        cfg = base.replace(memory=dataclasses.replace(
            base.memory, voxel_capacity=(1 << 10) - 8,
            replacement="surprise", surprise_exact=exact,
            surprise_threshold=0.9))
        V = cfg.memory.voxel_capacity
        res = {}
        for d in ("cpu", dev):
            st = init_store(cfg.memory, device=d)
            for tk, pix in batches:
                st, _ = ingest_frames(
                    st, *(torch.from_numpy(a).to(d)
                          for a in (rgb, depth, poses, tk)), None, cfg,
                    pix=torch.from_numpy(pix).to(d))
            res[str(d)] = st
        a, b = res["cpu"], res[str(dev)]
        n = int(a.num_voxels)
        for f, rows in ints + (("feat_obs", -2),):
            rows = {-2: V}.get(rows, rows)
            x, y = getattr(a, f), getattr(b, f).cpu()
            if rows is not None:
                x, y = x[:rows], y[:rows]
            check(torch.equal(x, y), f"segments-parity: surprise {f}")
        err = max(float((getattr(b, f)[:r].cpu() - getattr(a, f)[:r]).abs()
                        .max()) for f, r in (("feats", n * K),
                                             ("feat_sum", n)))
        check(err <= SEG_PARITY_TOL,
              f"segments-parity: surprise rows err {err}")
        for st in (a, b):
            forgetting_pass(st)
        check(torch.equal(a.feat_count, b.feat_count.cpu()),
              "segments-parity: forgetting counts")
        ferr = float((b.feats.cpu() - a.feats).abs().max())
        check(ferr <= SEG_PARITY_TOL,
              f"segments-parity: forgetting rows err {ferr}")
        out["exact" if exact else "mean-field"] = {
            "voxels": n, "rows_err": err, "forget_rows_err": ferr}
    # a segmented store: 248 slots, 5 single-frame batches, one device
    # segment, the rest spilled
    cfg = base.replace(memory=dataclasses.replace(base.memory,
                                                  voxel_capacity=248))
    frames = []
    for i in range(5):
        r = np.random.default_rng(seed + 40 + i)
        fp = poses[:1].copy()
        fp[:, :3] = i * 1.2
        frames.append((r.integers(0, 255, size=(1, H, W, 3), dtype=np.uint8),
                       r.uniform(0.2, 4.0, size=(1, H, W)).astype(np.float32),
                       fp, r.normal(size=(1, 2, 2, D)).astype(np.float32),
                       r.integers(0, H * W, size=(1, P)),
                       r.integers(0, K, size=P)))
    tops = {}
    qv = rng.normal(size=D).astype(np.float32)
    for d in ("cpu", dev):
        seg = SegmentedStore(cfg.memory, max_device_segments=1, device=d)
        for rgb_, dep, ps, tk, pix, repl in frames:
            seg.state, _ = ingest_frames(
                seg.state, *(torch.from_numpy(x).to(d)
                             for x in (rgb_, dep, ps, tk)), None, cfg,
                pix=torch.from_numpy(pix).to(d),
                repl_idx=torch.from_numpy(repl).to(d))
            seg.rotate_if_full()
        check(len(seg.host_segments) >= 1 and len(seg.device_segments) == 1,
              "segments-parity: no spill")
        before = counts()
        tops[str(d)] = seg.localize(torch.from_numpy(qv).to(d), top_k=16)
        if d != "cpu":
            want = launches(K2=1, K2b=seg.num_segments - 1)
            check(since(before) == want, f"segments-parity: localize "
                  f"launched {fmt(since(before))} (want {fmt(want)})")
        out["segments"] = seg.num_segments
    (cp, cs), (gp, gs) = tops["cpu"], tops[str(dev)]
    err = float(np.abs(gs - cs).max())
    check(len(cs) == len(gs) > 0 and err <= 2e-5,
          f"segments-parity: merged scores err {err}")
    kth = cs.min()
    check({tuple(p) for p, s_ in zip(cp, cs) if s_ > kth + 4e-5}
          == {tuple(p) for p, s_ in zip(gp, gs) if s_ > kth + 4e-5},
          "segments-parity: merged top-K differs")
    out["merged_score_err"] = err
    log("segments-parity", f"small_test_config: surprise stores equal "
        f"(mean-field {out['mean-field']['voxels']}, exact "
        f"{out['exact']['voxels']} voxels; rows err "
        f"{out['mean-field']['rows_err']:.3g} / "
        f"{out['exact']['rows_err']:.3g}), forgetting_pass counts equal "
        f"(rows err {out['mean-field']['forget_rows_err']:.3g} / "
        f"{out['exact']['forget_rows_err']:.3g}); a segmented store of "
        f"{out['segments']} segments (1 int8 on the card, the rest spilled): "
        f"the merged top-16 equal, score err {err:.3g}")
    return out


def kernel_cases_only(names, seed) -> int:
    """``--kernels``: the named kernels' cases alone, on the card."""
    from bsc_nav_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = {"K2": k2_cases, "K4": k4_cases,
           "K5": lambda d, g, c: long_attention_cases(d, g, c, ("K5",)),
           "K6": lambda d, g, c: long_attention_cases(d, g, c, ("K6",)),
           "K7": layer_norm_cases, "K8": conv_cases}
    check(set(names) <= set(run), f"--kernels {names}: only {sorted(run)}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    log("build", f"in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for name in names:
        run[name](dev, gen, cases)
    print(json.dumps({"cases": cases}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="",
                    help="only the kernel cases of these kernels (of K2, "
                    "K4, K5, K6, K7, K8, comma separated; K2 includes its "
                    "Q-query scan): build, check, time, "
                    "print their cases as JSON, and stop -- a measurement "
                    "run, not the smoke")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this "
              "script runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.kernels:
        return kernel_cases_only(args.kernels.split(","), args.seed)
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
    # each main path runs with the counts set to 0 just before it and is
    # read just after: the spine (slice f32, bf16), batched queries on
    # each slice's store, the int8 store and persistence, the int8 encoder
    spine = batch_path = launches()
    slices, batches, forgets = [], [], []
    for dt in (torch.float32, torch.bfloat16):
        reset_counts()
        result, mem = phase_slice(dev, dt, cfg, vcfg, world, args.seed)
        spine = add(spine, counts())
        slices.append(result)
        reset_counts()
        batches.append(phase_batch(dev, mem, cfg, vcfg, world))
        batch_path = add(batch_path, counts())
        if dt == torch.float32:
            reset_counts()
            mem8, tops8, flush8, query8 = phase_int8(dev, mem, cfg, vcfg,
                                                     world)
            int8_path = counts()
            with uncounted():
                int8 = int8_checks(mem8, mem, tops8, world, cases)
            int8.update(flush_ms=flush8, query_ms=query8)
            params32 = mem.perception.vit_params
            spine_pos = mem.state.slot_pos[:int(mem.state.num_voxels)
                                           ].cpu().numpy()
        forgets.append(forget_case(f"spine {str(dt)[6:]}", mem.state))
        del mem
        torch.cuda.empty_cache()
    log("slice", f"launches on the memory spine: {fmt(spine)}")
    check(spine[0] > 0 and spine[1] > 0 and not any(spine[2:]),
          f"memory spine launches {fmt(spine)}")
    # per store: the sweep (1 prompt, 1 launch), 16 goals (1) and Q 17 (2)
    log("batch", f"launches on the batched-query path: {fmt(batch_path)}")
    check(batch_path == launches(K1=2 * 34 * vcfg.depth, K2b=8),
          f"batched-query launches {fmt(batch_path)}")
    log("int8", f"launches on the int8-store path: {fmt(int8_path)}")
    check(int8_path == launches(K1=(N_FRAMES // BATCH + N_QUERIES)
                                * vcfg.depth, K2b=N_QUERIES),
          f"int8-store launches {fmt(int8_path)}")
    reset_counts()
    persist = phase_persist(dev, cfg, args.seed, mem8)
    persist_path = counts()
    check(persist_path == launches(),
          f"persist launches {fmt(persist_path)} (want none)")
    forgets.append(forget_case("spine int8", mem8.state))
    del mem8
    log("forget", "forgetting_pass (threshold 0.95) on the spine's stores "
        "at full capacity (131,080 slots), in place, twice each: " + "; ".join(
            f"{f['store']} {[round(t, 2) for t in f['ms']]} ms, voxels "
            f"{f['voxels_before']} -> {f['voxels_after']}, rows "
            f"{f['rows_before']:,} -> {f['rows_after']:,}" for f in forgets)
        + "; rows past every count zero-norm, int8 scales 1.0 there")
    reset_counts()
    perc8, mem8e, enc = phase_int8_encoder(dev, cfg, vcfg, world, params32)
    enc_path = counts()
    log("int8 encoder", f"launches on the path: {fmt(enc_path)}")
    check(enc_path == launches(K1=2 * vcfg.depth, K2=1),
          f"int8 encoder launches {fmt(enc_path)}")
    with uncounted():
        enc = int8_encoder_checks(dev, cfg, params32, world, enc)
    del perc8, mem8e
    torch.cuda.empty_cache()
    reset_counts()
    surprise = phase_surprise(dev, cfg, vcfg, world, params32,
                              slices[0]["flush_ms"])
    surprise_path = counts()
    log("surprise", f"launches on the path: {fmt(surprise_path)}")
    check(surprise_path == launches(
        K1=(N_FRAMES // BATCH + 2 + N_QUERIES) * vcfg.depth, K2=N_QUERIES),
          f"surprise launches {fmt(surprise_path)}")
    reset_counts()
    segments, segments_path = phase_segments(dev, cfg, vcfg, world, params32,
                                             spine_pos, args.seed)
    log("segments", f"launches on the path: {fmt(segments_path)}")
    seg_k2b = segments["segments"] - 1
    check(segments_path == launches(
        K1=(N_FRAMES // BATCH + N_QUERIES + 1) * vcfg.depth,
        K2=N_QUERIES + 3, K2b=(N_QUERIES + 3) * seg_k2b),
          f"segments launches {fmt(segments_path)}")
    forgets.append(segments["full_capacity"]["forget"])
    reset_counts()
    explore = phase_explore(dev, cfg, vcfg, params32, args.seed)
    explore_path = counts()
    log("explore", f"launches on the path: {fmt(explore_path)}")
    reset_counts()
    robot_parity, robot_parity_path = phase_robot_parity(dev, args.seed)
    log("robot-parity", f"launches on the card's path: "
        f"{fmt(robot_parity_path)}")
    seg_parity = phase_segments_parity(dev, args.seed)
    del params32
    torch.cuda.empty_cache()
    parity_err = phase_parity(dev, args.seed)

    reset_counts()
    clip = phase_clip(dev, cfg, vcfg, world, args.seed)
    clip_path = counts()
    log("clip", f"launches on the CLIP path (DINOv2 ingest included): "
        f"{fmt(clip_path)}")
    check(clip_path[2] > 0 and not any(clip_path[3:]),
          f"CLIP path launches {fmt(clip_path)}")
    clip_parity = phase_clip_parity(dev, args.seed)

    yolo, yolo_path = phase_yolo(dev, cfg, vcfg, world, args.seed)
    log("yolo", f"launches on the YOLO path (DINOv2 ingest included): "
        f"{fmt(yolo_path)}")
    check(yolo_path == launches(K1=8 * vcfg.depth,
                                K8=4 * (K8_PER_FORWARD + 36)),
          f"YOLO path launches {fmt(yolo_path)}")
    yolo_parity = phase_yolo_parity(dev, args.seed)

    textq, textq_paths, textq_w = phase_textq_all(dev, cfg, vcfg, world,
                                                  args.seed)
    for name, c in textq_paths.items():
        log(name, f"launches on the path (DINOv2 ingest included): {fmt(c)}")
    # the robots at full width, on the text-query phases' bf16 weights
    reset_counts()
    robot = phase_robot(dev, cfg, world, textq_w, args.seed)
    robot_path = counts()
    del textq_w
    torch.cuda.empty_cache()
    log("robot", f"launches on the path (memory build and three episodes): "
        f"{fmt(robot_path)}")
    # K1, K2, K3, K4 and K2b; none of K5-K8
    check(all((robot_path[i] > 0) == (i in (0, 1, 2, 3, 8))
              for i in range(9)), f"robot launches {fmt(robot_path)}")
    # path: the kernels it must have launched; K7 lies on no path, K8 on
    # the YOLO path alone
    for name, used in (("textq", (0, 1, 2, 3)),
                       ("textq-sd3-medium", (0, 1, 2, 4)),
                       ("textq-sd35-1024", (0, 1, 2, 3, 5))):
        c = textq_paths[name]
        check(all((c[i] > 0) == (i in used) for i in range(8)),
              f"{name} launches {fmt(c)}")
    textq_parity = phase_textq_parity(dev, args.seed)
    stray = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "bsc_nav_tpu"))
    check(not stray, f"imported {stray[:5]}")

    paths = {"spine": spine, "batch": batch_path, "int8": int8_path,
             "persist": persist_path, "int8-encoder": enc_path,
             "surprise": surprise_path, "segments": segments_path,
             "explore": explore_path, "robot-parity": robot_parity_path,
             "clip": clip_path, "yolo": yolo_path, **textq_paths,
             "robot": robot_path}

    def main_case(kernel, dtype="float32", **match):
        match = match or {"B": 8}
        return next(c for c in cases if c["kernel"] == kernel
                    and c["dtype"] == dtype
                    and all(c.get(k, v) == v for k, v in match.items()))

    # the shared tiles K1, K3, K5 and K6 run, by dtype
    csrc = "bsc_nav_tpu_torch/csrc/"
    tiles = {"tiles": {"bfloat16": csrc + "attention_mma.cuh",
                       "float32": csrc + "attention_tf32.cuh"}}
    long_tiles = {"tiles": {"bfloat16, head_dim 64": csrc
                            + "attention_tma.cuh", **tiles["tiles"]}}

    def entry(name, source, replaces, i, case, **extra):
        by_path = {p: n[i] for p, n in paths.items()}
        return {"name": name, "route": "cuda",
                "source": f"bsc_nav_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"], **extra,
                "cases": [c for c in cases if c["kernel"] == case["kernel"]]}

    print(json.dumps({"kernels": [
        entry("short_attention_qkv", "short_attention_qkv.cu",
              "bsc_nav_tpu/ops/flash_attention.py:422", 0, main_case("K1"),
              **tiles),
        entry("max_cosine_per_voxel", "max_cosine.cu",
              "bsc_nav_tpu/ops/similarity.py:56", 1, main_case("K2"),
              bfloat16=main_case("K2", "bfloat16"),
              int8="the Q-query kernel at Q 1 (max_cosine_per_voxel_batch)"),
        entry("max_cosine_per_voxel_batch", "max_cosine.cu",
              "bsc_nav_tpu/ops/similarity.py:121 (XLA einsum in the JAX "
              "package; no pallas_call)", 8,
              main_case("K2b", Q=16, store="random counts"),
              by_dtype={d: [main_case("K2b", d, Q=Q, store=st)
                            for Q, st in ((1, "random counts"),
                                          (3, "random counts"),
                                          (16, "random counts"),
                                          (16, "sparse"))]
                        for d in ("float32", "bfloat16", "int8")},
              device_kernels={str(d)[6:]: k for d, k in K2B_KERNEL.items()},
              ptxas=ptxas_usage("max_cosine.cu", "max_cosine_"),
              library="GEMM + mask + max"),
        entry("short_attention", "short_attention.cu",
              "bsc_nav_tpu/ops/flash_attention.py:364", 2,
              main_case("K3", case="vision"),
              **tiles),
        entry("joint_qkv_attention", "joint_qkv_attention.cu",
              "bsc_nav_tpu/ops/flash_attention.py:550", 3,
              main_case("K4", "bfloat16", case="joint"),
              float32=main_case("K4", case="joint"),
              device_kernels=["joint_qkv_norm_kernel (the qk-norm "
                              "pre-pass, joint_qkv_attention.cu)",
                              "the tile on its rows"],
              tiles={"bfloat16": csrc + "attention_tma.cuh",
                     "float32": csrc + "attention_tf32.cuh"}),
        entry("mid_attention", "mid_attention.cu",
              "bsc_nav_tpu/ops/flash_attention.py:215", 4,
              main_case("K5", "bfloat16", case="sd3-medium-512"),
              also_replaces="tools/mid_attention_exp.py:56",
              float32=main_case("K5", case="sd3-medium-512"), **long_tiles),
        entry("flash_attention", "flash_attention.cu",
              "bsc_nav_tpu/ops/flash_attention.py:121", 5,
              main_case("K6", "bfloat16", case="sd35-medium-1024"),
              float32=main_case("K6", case="sd35-medium-1024"),
              **long_tiles),
        entry("layer_norm", "layer_norm.cu",
              "bsc_nav_tpu/ops/layernorm.py:47", 6, main_case("K7"),
              tiles={"float32": "layer_norm_kernel<float, 8>",
                     "bfloat16": "layer_norm_kernel<__nv_bfloat16, 4>"},
              dispatched="nowhere, as in the JAX package"),
        entry("conv3x3_s1", "conv3x3_s1.cu",
              "bsc_nav_tpu/ops/conv2d.py:120", 7,
              main_case("K8", case="40x40x320->320"),
              bfloat16=main_case("K8", "bfloat16", case="40x40x320->320"),
              tiles={str(d)[6:]: t for d, t in K8_TILES.items()},
              launches_per_flush={n: yolo[n]["k8_per_flush"]
                                  for n in ("f32", "int8-neck")},
              dispatched="YOLO-World's f32 3x3 stride-1 convs "
                         "(models/yolo_world.conv_bn_act)"),
    ], "slices": slices, "batch": batches, "int8": int8,
        "persist": persist, "int8_encoder": enc, "surprise": surprise,
        "forget": forgets, "segments": segments, "explore": explore,
        "segments_parity": seg_parity,
        "slice_parity_max_err": parity_err, "clip": clip,
        "clip_parity": clip_parity, "yolo": yolo, "yolo_parity": yolo_parity,
        "textq": textq,
        "textq_parity": textq_parity, "robot_parity": robot_parity,
        "robot": robot}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
