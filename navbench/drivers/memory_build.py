"""The memory build: RGB-D frames pushed into ``VoxelTokenMemory`` in a
closed loop, 8 at a time (the habitat world's ``build_habitat_world``
memory with no detector feeding a long-term memory).

Set-up draws the weights on the card, builds the program's encoder and
memory from the configuration file, renders the patrol's loop
(``navbench/scene.py``) and pushes the traffic's warm-up flushes.  The
window then pushes the walk's next frames, as host numpy arrays, until
``--seconds`` have passed: every 8th push flushes, and the flush's time is
that push plus a synchronise.  A traced run profiles the window's last
``trace_seconds``.

The check, once the window has closed: the reference (``reference/``)
encodes every bank view in f32, replays every flush of the run into its
own store from the same draws and tokens, and the two stores are compared
voxel by voxel (by voxel id).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from navbench import arith, scene
from navbench import weights as W
from navbench.harness import Check, Outcome, Spans, Tracer, device_info
from navbench.reference import dinov2
from navbench.reference.common import full_f32
from navbench.reference.voxel_memory import VoxelMemory

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# colour sums and weights: f32 atomics against float64 sums
FUSION_TAU = 1e-3


def seeds(seed: int) -> Dict[str, int]:
    names = ("vit", "scene", "memory")
    vals = np.random.SeedSequence(seed).generate_state(len(names), np.uint64)
    return {n: int(v) for n, v in zip(names, vals)}


def program_config(c: Dict, memory_seed: int, control: bool):
    """The port's Config for the configuration file ``c``."""
    from bsc_nav_tpu_torch.config import (
        Config, MemoryConfig, ModelConfig, QueryConfig, SensorConfig)
    m = c["memory"]
    return Config(
        sensor=SensorConfig(**c["sensor"]),
        memory=MemoryConfig(
            cell_size=m["cell_size"], grid_size=m["grid_size"],
            floor_height=m["floor_height"], map_height=m["map_height"],
            token_dim=m["token_dim"], cache_size=m["cache_size"],
            depth_sample_rate=m["depth_sample_rate"],
            voxel_capacity=m["voxel_capacity"],
            alpha_sigma_sq=m["alpha_sigma_sq"],
            replacement=m["replacement"]),
        query=QueryConfig(query_width=c["query"]["query_width"],
                          query_height=c["query"]["query_height"]),
        models=ModelConfig(encoder=c["encoder"]["name"],
                           encoder_int8=bool(c["encoder"]["int8"] or control)),
        seed=memory_seed)


def vit_config(e: Dict):
    from bsc_nav_tpu_torch.models import vit
    keys = ("img_size", "patch_size", "dim", "depth", "heads", "mlp_ratio",
            "num_registers", "layerscale", "qkv_bias", "ffn", "ln_eps",
            "gelu_exact")
    return vit.ViTConfig(**{k: e[k] for k in keys})


@dataclasses.dataclass
class Walk:
    """The bank of the patrol's loop and the frames pushed so far."""

    rgb: np.ndarray
    depth: np.ndarray
    poses: np.ndarray
    pushed: int = 0

    def flush(self, f: int, B: int):
        """Bank views and poses of flush f's B frames."""
        idx = np.arange(f * B, (f + 1) * B) % len(self.poses)
        return idx, self.poses[idx]

    def push(self, mem) -> None:
        i = self.pushed % len(self.poses)
        mem.push_frame({"rgb": self.rgb[i], "depth": self.depth[i]},
                       scene.walk_pose(self.poses, self.pushed))
        self.pushed += 1


def run(ctx) -> Outcome:
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import vit

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    cuda = torch.device(dev).type == "cuda"
    sd = seeds(ctx.seed)
    B = c["batch"]
    cfg = program_config(c, sd["memory"], ctx.control)
    vcfg = vit_config(c["encoder"])
    compute = DTYPES[c["encoder"]["dtype"]]
    spans = Spans()
    marks = {}

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        marks[f"setup_{name}_s"] = round(time.perf_counter() - ctx.t_start,
                                         3)

    mark("imports")
    # --- set-up: weights on the card, the program's model and memory -----
    wv = W.draw(W.dinov2_specs(c["encoder"]), sd["vit"], dev)
    vitm = vit.ViT(vcfg, dtype=compute, device=dev)
    vitm.load_state_dict(wv, strict=True)
    del wv
    perception = Perception.create(cfg, vit_cfg=vcfg, vit_params=vitm,
                                   batch_size=B, compute_dtype=compute,
                                   device=dev)
    perception = dataclasses.replace(
        perception, build_step=spans.wrap("encode_ingest",
                                          perception.build_step))
    mem = VoxelTokenMemory(cfg, None, perception, detector=None,
                           store_dtype=DTYPES[c["memory"]["store_dtype"]])
    mark("models")
    s = c["sensor"]
    bank_poses = scene.bank_poses(tr)
    if len(bank_poses) % B:
        raise ValueError("the patrol's loop must hold whole batches")
    rgb, depth = scene.render(bank_poses, tr, sd["scene"], s["height"],
                              s["width"], s["hfov_deg"], s["sensor_height"],
                              dev)
    walk = Walk(rgb, depth, bank_poses)
    mark("render")
    for _ in range(tr["warmup_flushes"] * B):
        walk.push(mem)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.say(f"set-up {setup_s:.3f} s")

    # --- the window ---------------------------------------------------------
    flush_s: List[float] = []
    tracer = None
    traced_from, traced_t0 = None, float("inf")
    t0 = time.perf_counter()
    while True:
        if (ctx.trace and tracer is None and time.perf_counter() - t0
                >= ctx.seconds - tr["trace_seconds"]):
            tracer = Tracer(spans).__enter__()
            traced_t0 = time.perf_counter()
            traced_from = len(flush_s)
        for _ in range(B - 1):
            walk.push(mem)
        with spans("flush"):
            f0 = time.perf_counter()
            walk.push(mem)
            if cuda:
                torch.cuda.synchronize()
            flush_s.append(time.perf_counter() - f0)
        now = time.perf_counter()
        # a traced run also gives its traced part its whole length
        if (now - t0 >= ctx.seconds and (tracer is None or now - traced_t0
                                         >= tr["trace_seconds"])):
            break
    window_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.__exit__(None, None, None)
    device = device_info(ctx.cell["chips"]) if cuda else {}
    n_window = len(flush_s)
    e2e = {"build_fps": B * n_window / window_s,
           "flush_ms_p95": float(np.percentile(np.array(flush_s) * 1e3, 95)),
           "setup_s": setup_s}
    ctx.say(f"window {window_s:.3f} s: {n_window} flushes, "
            f"{B * n_window} frames; build_fps {e2e['build_fps']:.4f}, "
            f"flush ms p50 {np.percentile(flush_s, 50) * 1e3:.3f} p95 "
            f"{e2e['flush_ms_p95']:.4f} max {max(flush_s) * 1e3:.3f}")
    trace = tracer.result() if tracer is not None else None
    split = {}
    if trace is not None:
        split, rest = arith.kernel_split(
            (n, e - s_) for n, s_, e in trace.kernels)
        split["rest's largest"] = rest
    traced_items = n_window - traced_from if tracer is not None else 0

    # --- the check ----------------------------------------------------------
    state = mem.state
    n_flushes = walk.pushed // B
    del mem, perception, vitm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, info = check(ctx, c, cfg, sd, walk, state, n_flushes)
    info["check_s"] = round(time.perf_counter() - t_check, 3)
    info.update(marks)
    info["window_flushes"] = n_window
    q = np.array_split(np.array(flush_s) * 1e3, min(4, n_window))
    info["flush_ms_mean_by_quarter"] = [round(float(x.mean()), 3) for x in q]
    info["traced_flushes"] = traced_items
    if split:
        info["traced_device_s_by_kind"] = split
    return Outcome(e2e=e2e, attempted=n_window, failed=0, checks=checks,
                   device=device, spans=spans, trace=trace,
                   traced_items=traced_items, window_t0=t0,
                   traced_t0=traced_t0, info=info)


@torch.no_grad()
def check(ctx, c, cfg, sd, walk, state, n_flushes: int):
    dev = ctx.device
    B, N = c["batch"], len(walk.poses)
    m, s = c["memory"], c["sensor"]
    qsize = c["query"]["query_width"]
    compute = DTYPES[c["encoder"]["dtype"]]
    info = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        info[f"check_{name}_s"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()

    # reference tokens of every bank view the run pushed
    wv = W.served(W.draw(W.dinov2_specs(c["encoder"]), sd["vit"], dev),
                  compute)
    used = sorted(set((np.arange(n_flushes * B) % N).tolist()))
    tokens = None
    with full_f32():
        for j in range(0, len(used), B):
            views = used[j:j + B]
            g = dinov2.patch_grid(wv, c["encoder"], qsize, torch.from_numpy(
                walk.rgb[views]).to(dev)).cpu().numpy()
            if tokens is None:
                tokens = np.zeros((N,) + g.shape[1:], np.float32)
            tokens[views] = g
    del wv
    lap("tokens")

    # replay every flush of the run into the reference store; the
    # control's geometry is the reference's own, its products in TF32
    def replay(**kw):
        vm = VoxelMemory(m, s, cfg.seed, dev, **kw)
        for f in range(n_flushes):
            idx, poses = walk.flush(f, B)
            vm.ingest(walk.rgb[idx], walk.depth[idx], poses, tokens[idx])
        return vm

    vm = replay(edge_m=c["check"]["edge_m"])
    lap("replay")
    p = program_store(c, state)
    if ctx.control:
        p_geom = reference_store(replay(tf32=True))
        lap("replay_tf32")
    else:
        p_geom = p
    info.update({"store_points_drawn": n_flushes * B * -(
                     -s["height"] * s["width"] // m["depth_sample_rate"]),
                 "store_points_gated": vm.gated,
                 "store_voxels_added": vm.added,
                 "store_points_replaced": vm.replaced,
                 "store_points_dropped_full": vm.dropped})
    checks = [compare_rows(c, state, p, vm, info),
              compare_voxels(c, p_geom, vm, info)]
    lap("compare")
    return checks, info


def program_store(c, state) -> Dict:
    """The program's store as the comparison reads it, keyed by voxel id
    and top-down cell."""
    m = c["memory"]
    G, cs = m["grid_size"], m["cell_size"]
    Hc = int(m["map_height"] / cs) - int(m["floor_height"] / cs)
    n = int(state.num_voxels)
    pos = state.slot_pos[:n].long().cpu().numpy()
    mh = state.max_height[:G * G].cpu().numpy()
    cv = state.cv_map[:G * G].cpu().numpy()
    cells = np.nonzero(mh >= 0)[0]
    return {"vid": (pos[:, 0] * G + pos[:, 1]) * Hc + pos[:, 2],
            "count": state.feat_count[:n].cpu().numpy().astype(np.int64),
            "rgb_sum": state.rgb_sum[:n].cpu().numpy().astype(np.float64),
            "weight": state.weight[:n].cpu().numpy().astype(np.float64),
            "cells": {int(cl): (int(mh[cl]), tuple(int(x) for x in cv[cl]))
                      for cl in cells}}


def reference_store(vm: VoxelMemory) -> Dict:
    """A reference store in the form of ``program_store``."""
    vid = np.fromiter(vm.slot.keys(), np.int64, len(vm.slot))
    slot = np.fromiter(vm.slot.values(), np.int64, len(vm.slot))
    return {"vid": vid, "count": vm.count[slot], "rgb_sum": vm.rgb_sum[slot],
            "weight": vm.weight[slot], "cells": dict(vm.cells)}


def compare_voxels(c, p: Dict, vm: VoxelMemory, info: Dict) -> Check:
    """The store's geometry and fusion: the share of voxels and top-down
    cells, over both stores, that differ from the reference's -- a voxel
    on one side only, or whose token count, colour sums or weight differ;
    a cell whose height or colour differs or that is on one side only.
    Voxels and cells a point near an edge could reach are left out."""
    r = reference_store(vm)
    r_at = {int(v): i for i, v in enumerate(r["vid"])}
    unsure = vm.unsure_voxels
    p_sure = np.array([int(v) not in unsure for v in p["vid"]], bool)
    r_sure = np.array([int(v) not in unsure for v in r["vid"]], bool)
    ri = np.array([r_at.get(int(v), -1) for v in p["vid"]], np.int64)
    both = p_sure & (ri >= 0)
    j = ri[both]
    same = p["count"][both] == r["count"][j]
    same &= (np.abs(p["rgb_sum"][both] - r["rgb_sum"][j]).max(1)
             <= FUSION_TAU * np.maximum(np.abs(r["rgb_sum"][j]).max(1), 1.0))
    same &= np.abs(p["weight"][both] - r["weight"][j]) <= FUSION_TAU * \
        np.maximum(r["weight"][j], 1e-3)
    n_both = int(both.sum())
    p_only = int(p_sure.sum()) - n_both
    r_only = int(r_sure.sum()) - n_both
    v_off = p_only + r_only + int((~same).sum())
    v_union = n_both + p_only + r_only
    pc, rc = p["cells"], r["cells"]
    keys = (set(pc) | set(rc)) - vm.unsure_cells
    c_off = sum(pc.get(k) != rc.get(k) for k in keys)
    info.update({"voxels_program": len(p["vid"]),
                 "voxels_reference": len(r["vid"]),
                 "voxels_unsure": len(unsure),
                 "voxels_compared": v_union, "voxels_one_side":
                 p_only + r_only, "voxels_differ": int((~same).sum()),
                 "cells_compared": len(keys), "cells_off": c_off})
    share = (v_off + c_off) / max(v_union + len(keys), 1)
    return Check("voxels_off", share, c["limits"]["voxels_off"],
                 "share of voxels and top-down cells off the reference's "
                 "(count, colour sums, weight)")


def compare_rows(c, state, p: Dict, vm: VoxelMemory, info: Dict) -> Check:
    """The tokens: the share of stored rows, over both stores, that are
    off -- on one side only (a voxel's rows there, or the rows one count
    exceeds the other by), or further than ``row_gap`` (relative L2) from
    the reference's row."""
    K = c["memory"]["cache_size"]
    g0 = c["check"]["row_gap"]
    r = reference_store(vm)
    both, pi, rj = np.intersect1d(p["vid"], r["vid"], return_indices=True)
    pn, rn = p["count"][pi], r["count"][rj]
    one_side = (p["count"].sum() - pn.sum()) + (r["count"].sum() - rn.sum())
    union = int(one_side + np.maximum(pn, rn).sum())
    off = int(one_side + np.abs(pn - rn).sum())
    rslot = np.fromiter(vm.slot.values(), np.int64, len(vm.slot))[rj]
    n = len(p["vid"])
    dev = state.feats.device
    feats = state.feats[:n * K].view(n, K, state.feats.shape[1])
    gaps = []
    for a in range(0, len(both), 4096):
        sel = slice(a, a + 4096)
        pf = feats[torch.from_numpy(pi[sel]).to(dev)].float()
        rf = torch.from_numpy(vm.feats[rslot[sel]]).to(dev)
        live = (torch.arange(K, device=dev)[None, :] < torch.from_numpy(
            np.minimum(pn[sel], rn[sel])).to(dev)[:, None])
        rel = (torch.linalg.norm(pf - rf, dim=-1)
               / torch.linalg.norm(rf, dim=-1).clamp_min(1e-12))
        gaps.append(rel[live].cpu().numpy())
    rows = np.concatenate(gaps) if gaps else np.zeros(0)
    off += int((rows > g0).sum())
    q = (np.quantile(rows, [0.5, 0.9, 0.99, 0.999]).round(6).tolist()
         if rows.size else None)
    info.update({"rows_compared": int(rows.size),
                 "row_gap_q50_q90_q99_q999": q,
                 "row_gap_max": float(rows.max()) if rows.size else None,
                 "rows_over": {t: float((rows > t).mean()) for t in
                               (0.015, 0.02, 0.025, 0.03, 0.05, 0.5)}
                 if rows.size else None})
    return Check("rows_off", off / max(union, 1), c["limits"]["rows_off"],
                 f"share of stored rows off the reference's (a row by more "
                 f"than {g0} relative L2)")
