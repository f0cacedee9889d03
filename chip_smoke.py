#!/usr/bin/env python3
"""Drive the PyTorch port's memory spine once on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, one line each (any failed check raises, so the script exits
non-zero):

  build         compile bsc_nav_tpu_torch/csrc/*.cu with nvcc for sm_90a
  kernels       K1 short_attention_qkv and K2 max_cosine_per_voxel against
                their plain PyTorch versions on the card, at the main path's
                shapes, with both times (CUDA events, median of 20 runs)
  slice f32     the full default Config() -- 680x680 RGB-D, 1000^2 x 200
                grid, 131,080 slots x 10 tokens x 1024 -- through
                Perception / VoxelTokenMemory with a random-init DINOv2
                ViT-L/14-reg: 32 frames (4 flushes of 8), then 3 image
                queries of 3 images (one with a region radius); launch
                counts, store and top-K checks, times per flush and query
  slice bf16    the same with bf16 weights, compute and store
  slice-parity  small_test_config() and a tiny ViT (head_dim 16): the same
                frames and injected draws on the CPU (plain versions) and
                on the card (kernels); equal store, equal top-K

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
K1_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
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
    from bsc_nav_tpu_torch.ops import flash_attention, similarity
    return (flash_attention.short_attention_qkv.launches,
            similarity.max_cosine_per_voxel.launches)


def reset_counts() -> None:
    from bsc_nav_tpu_torch.ops import flash_attention, similarity
    flash_attention.short_attention_qkv.launches = 0
    similarity.max_cosine_per_voxel.launches = 0


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
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phase: slice at the full default config
# ---------------------------------------------------------------------------

def render_world(cfg, seed):
    """32 frames turning in place, and 3 query groups of 3 close-up views
    of the scene's first three boxes, from the fake environment."""
    from bsc_nav_tpu.env.fake import BoxScene, FakeNavEnv
    from bsc_nav_tpu.env.pathfinding import AgentState, Quat

    scene = BoxScene.default()
    env = FakeNavEnv(cfg, scene=scene, seed=seed)
    env.reset(init_state=AgentState(np.zeros(3), Quat.from_yaw(0.0)),
              build_map=True)
    frames = []
    obs = env.sims.get_sensor_observations(0)
    for _ in range(N_FRAMES):
        frames.append(({"rgb": obs["rgb"], "depth": obs["depth"]},
                       env.agent_pose_vec()))
        obs = env.step("turn_left")
    queries = []
    for box in scene.boxes[:N_QUERIES]:
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
        k1, k2 = counts()
        t0 = time.perf_counter()
        for obs, pose in frames[i * BATCH:(i + 1) * BATCH]:
            mem.push_frame(obs, pose)              # the 8th push flushes
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        d1, d2 = counts()[0] - k1, counts()[1] - k2
        check(d1 == vcfg.depth and d2 == 0,
              f"flush {i}: K1 +{d1}, K2 +{d2} (want +{vcfg.depth}, +0)")
    nv = int(mem.state.num_voxels)
    check(nv > 0, "no voxels after 32 frames")
    check(int(mem.state.feat_count[:nv].min()) >= 1, "empty live voxel")

    query_ms, best = [], None
    for i, imgs in enumerate(queries):
        k1, k2 = counts()
        radius = 50.0 if i == N_QUERIES - 1 else np.inf
        t0 = time.perf_counter()
        out = mem.voxel_localized(imgs, K=cfg.query.top_k,
                                  region_radius=radius, curr_grid=best)
        query_ms.append((time.perf_counter() - t0) * 1e3)
        d1, d2 = counts()[0] - k1, counts()[1] - k2
        check(d1 == vcfg.depth and d2 == 1,
              f"query {i}: K1 +{d1}, K2 +{d2} (want +{vcfg.depth}, +1)")
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
    reset_counts()
    slices = [phase_slice(dev, dt, cfg, vcfg, world, args.seed)
              for dt in (torch.float32, torch.bfloat16)]
    launches = counts()
    check(all(n > 0 for n in launches), f"a kernel never ran: {launches}")

    parity_err = phase_parity(dev, args.seed)
    check("jax" not in sys.modules, "jax was imported")

    def main_case(kernel):
        return next(c for c in cases if c["kernel"] == kernel
                    and c["dtype"] == "float32" and c.get("B", 8) == 8)

    k1, k2 = main_case("K1"), main_case("K2")
    print(json.dumps({"kernels": [
        {"name": "short_attention_qkv", "route": "cuda",
         "source": "bsc_nav_tpu_torch/csrc/short_attention_qkv.cu",
         "replaces": "bsc_nav_tpu/ops/flash_attention.py:422",
         "launches": launches[0], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "cases": [c for c in cases if c["kernel"] == "K1"]},
        {"name": "max_cosine_per_voxel", "route": "cuda",
         "source": "bsc_nav_tpu_torch/csrc/max_cosine.cu",
         "replaces": "bsc_nav_tpu/ops/similarity.py:56",
         "launches": launches[1], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "cases": [c for c in cases if c["kernel"] == "K2"]},
    ], "slices": slices, "slice_parity_max_err": parity_err}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
