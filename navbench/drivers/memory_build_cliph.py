"""The memory build with the MetaCLIP ViT-H/14 patch detector: RGB-D
frames pushed into ``VoxelTokenMemory`` in a closed loop, 8 at a time, as
in ``memory_build``, with a ``ClipPatchDetector`` that detects in each
flush's frames and feeds the long-term instance memory (the habitat
world's ``build_habitat_world`` memory when ``--weights-dir`` holds
``metaclip_vith14.npz``).

Set-up is ``memory_build``'s, and besides draws the CLIP on the card from
its own seed (``navbench/weights_clip.py``), runs the plain reference
(``reference/metaclip.py``, f32) over the patrol's bank views up to the
projection, sets the structured term's scale from those tokens so that
the views give the configuration's boxes a frame (``weights_clip.
calibrate``), and builds the program's CLIP and detector from the
configuration file and those weights.  The window is ``memory_build``'s;
a wrapper keeps the detector's first embeddings and detections of each
distinct batch of the loop inside the window.

The check, once the window has closed: ``memory_build``'s store check
(``rows_off``, ``voxels_off``), then the reference's tokens of every bank
view go through the drawn projection to its patch embeddings, it draws
its boxes and replays every flush of the run into its own long-term
memory.  Compared:

- ``embed_gap``: the largest L2 distance between the program's unit patch
  embeddings, as the timed path produced them, and the reference's;
- ``boxes_off``: the share of (frame, class) box lists that differ (a box
  on one side only, another box, or a confidence further than
  ``score_tol``), over the pairs that lie clear of the reference's ties: a
  pair is left out where a patch of its class has a heat within
  ``heat_margin`` of the confidence, or, at or above that, a best class
  that leads the second by less than ``heat_margin`` (both classes' pairs
  then);
- ``instances_off``: the share of long-term instances at the window's
  end, by (label, voxel), on one side only or with confidences further
  than ``score_tol`` apart.  A reference instance whose centre lies
  within ``edge_m`` of a voxel's face pairs with the program's at any
  voxel it could fall into.  Where float32 may decide a merge otherwise
  -- another of those voxels on the other side of the merge distance,
  or two confidences within their possible error (in float32 the two may
  compare the other way) -- or an instance comes from an unclear pair,
  the slot is tainted, and so is every later one within the merge
  distance of a tainted place (``metaclip.Unsure``): tainted slots are
  left out, and so is a program instance near a tainted place.  A box's
  confidence p is a patch's heat, the softmax's largest share, which
  moves by at most ``2 logit_scale g p (1 - p)`` when each cosine moves
  by at most g: with g the ``embed_gap`` limit, and ``conf_slack`` for
  float32's own rounding, that bounds how far the program's may lie from
  the reference's.

A check that compares fewer boxes, clear pairs or instances than the
configuration's floors reads 1.0: a check over empty lists is not a
check.  Each run also prints what ``instances_off`` reads for the
program's instances moved by one voxel (``instances_off_shifted``), a
planted fault at the cell's size.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from navbench import arith, scene
from navbench import weights as W
from navbench import weights_clip as WC
from navbench.drivers.memory_build import (
    DTYPES, Walk, check as store_check, program_config, vit_config)
from navbench.drivers.memory_build import seeds as store_seeds
from navbench.harness import Check, Outcome, Spans, Tracer, device_info
from navbench.reference import metaclip
from navbench.reference.common import full_f32

# entropy that sets the CLIP's seeds apart from the store's, which
# ``memory_build.seeds`` derives from the run's seed alone
CLIP_STREAM = 0x434C4950
# the CLIP draws a run makes at most to reach the detection load
CLIP_DRAWS = 4


def clip_seeds(seed: int, draw: int = 0) -> Dict[str, int]:
    """The seeds of the CLIP's weights and class directions in its
    ``draw``-th draw for the run's ``seed``."""
    key = [seed, CLIP_STREAM] + ([draw] if draw else [])
    vals = np.random.SeedSequence(key).generate_state(2, np.uint64)
    return {"clip": int(vals[0]), "clip_dirs": int(vals[1])}


def seeds(seed: int) -> Dict[str, int]:
    """``memory_build``'s seeds, unchanged, and the CLIP's first draw's."""
    return dict(store_seeds(seed), **clip_seeds(seed))


def clip_config(d: Dict):
    """The port's CLIPConfig for the configuration's ``detector``."""
    from bsc_nav_tpu_torch.models import clip
    if d["vision_mlp"] != 4 * d["vision_width"] or \
            d["text_mlp"] != 4 * d["text_width"]:
        raise ValueError("the port's CLIP blocks take an MLP of 4 x width")
    keys = ("embed_dim", "image_size", "patch_size", "vision_width",
            "vision_layers", "vision_heads", "context_length", "vocab_size",
            "text_width", "text_heads", "text_layers", "ln_eps",
            "gelu_exact", "quick_gelu")
    return clip.CLIPConfig(**{k: d[k] for k in keys})


@dataclasses.dataclass
class Reference:
    """What the check's reference keeps of the drawn CLIP from set-up: the
    class prompts' unit text embeddings [C, E], every bank view's patch
    tokens before the projection [N, grid^2, width] (on the host), the
    projection as drawn, its structured term's scale and the draw that
    reached the detection load."""

    text: torch.Tensor
    tokens: torch.Tensor
    proj: torch.Tensor
    scale: float
    draw: int

    @torch.no_grad()
    def embeddings(self, batch: int, dev) -> np.ndarray:
        """[N, grid^2, E]: every bank view's unit patch embeddings."""
        proj = self.proj.to(dev)
        with full_f32():
            return np.concatenate([
                metaclip.project(self.tokens[j:j + batch].to(dev),
                                 proj).cpu().numpy()
                for j in range(0, len(self.tokens), batch)])


@torch.no_grad()
def draw_clip(d: Dict, seed: int, rgb: np.ndarray, batch: int, dev):
    """The CLIP's weights, with the structured term at the scale that puts
    the detection load of ``d`` on the bank views ``rgb``
    (``weights_clip.calibrate``), and the ``Reference`` the check needs
    of them.  A draw that cannot reach that load is drawn again, from the
    next of ``clip_seeds``; the last of ``CLIP_DRAWS`` keeps the range's
    top scale whatever it reaches."""
    for k in range(CLIP_DRAWS):
        sd = clip_seeds(seed, k)
        w = WC.draw_plain(d, sd["clip"], dev)
        with full_f32():
            text = metaclip.text_embeddings(w, d, metaclip.class_prompts(d))
            tokens = torch.cat([
                metaclip.value_tokens(w, d, torch.from_numpy(
                    rgb[j:j + batch]).to(dev))
                for j in range(0, len(rgb), batch)])
        term = WC.class_term(d, text, sd["clip_dirs"])
        scale = WC.calibrate(tokens, w["visual.proj"], term, text, d)
        if scale is not None:
            break
    if scale is None:
        scale = WC.SCALE_RANGE[1]
    with full_f32():
        w["visual.proj"] += scale * term
    return w, Reference(text=text.cpu(), tokens=tokens.cpu(),
                        proj=w["visual.proj"].to("cpu", copy=True),
                        scale=scale, draw=k)


class Kept:
    """Wraps a detector's ``embed`` and ``detect_batch`` in place: while
    ``on``, the first output of each distinct batch of the loop (flush f
    holds batch f mod ``n_batches``) is kept, as the timed path made it."""

    def __init__(self, det, n_batches: int):
        self.emb: Dict[int, np.ndarray] = {}
        self.dets: Dict[int, list] = {}
        self.on = False
        self.calls = 0
        self.batch = 0
        embed, detect = det.embed, det.detect_batch

        def kept_embed(rgbs):
            out = embed(rgbs)
            if self.on:
                self.emb.setdefault(self.batch, out)
            return out

        def kept_detect(rgbs):
            self.batch = self.calls % n_batches
            self.calls += 1
            out = detect(rgbs)
            if self.on:
                self.dets.setdefault(self.batch, out)
            return out

        det.embed, det.detect_batch = kept_embed, kept_detect


def run(ctx) -> Outcome:
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.models import clip, vit
    from bsc_nav_tpu_torch.models.detector import ClipPatchDetector
    from bsc_nav_tpu_torch.models.tokenizer import HashTokenizer

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    d = c["detector"]
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
    # --- set-up: weights on the card, the program's models and memory ----
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
    s = c["sensor"]
    bank_poses = scene.bank_poses(tr)
    if len(bank_poses) % B:
        raise ValueError("the patrol's loop must hold whole batches")
    rgb, depth = scene.render(bank_poses, tr, sd["scene"], s["height"],
                              s["width"], s["hfov_deg"], s["sensor_height"],
                              dev)
    walk = Walk(rgb, depth, bank_poses)
    mark("render")
    wc, ref = draw_clip(d, ctx.seed, rgb, B, dev)
    mark("clip_weights")
    ccfg = clip_config(d)
    cm = clip.CLIP(ccfg, dtype=DTYPES[d["dtype"]], device=dev)
    cm.load_state_dict(wc, strict=True)
    del wc
    if ctx.control:
        # the program's lower precision: the int8 W8A8 vision tower
        cm = clip.quantize_params(cm, "visual")
    det = ClipPatchDetector(
        cm, ccfg, HashTokenizer(vocab_size=d["vocab_size"],
                                context_length=d["context_length"]),
        d["classes"], d["confidence"], device=dev)
    mem = VoxelTokenMemory(cfg, None, perception, detector=det,
                           store_dtype=DTYPES[c["memory"]["store_dtype"]])
    mark("models")
    kept = Kept(det, len(bank_poses) // B)
    for _ in range(tr["warmup_flushes"] * B):
        walk.push(mem)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    ctx.say(f"set-up {setup_s:.3f} s")

    # --- the window ---------------------------------------------------------
    from bsc_nav_tpu_torch.utils.profiling import TELEMETRY
    counts0 = dict(TELEMETRY.counters)
    kept.on = True
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
    kept.on = False
    device = device_info(ctx.cell["chips"]) if cuda else {}
    n_window = len(flush_s)
    e2e = {"build_fps": B * n_window / window_s,
           "flush_ms_p95": float(np.percentile(np.array(flush_s) * 1e3, 95)),
           "setup_s": setup_s}
    ctx.say(f"window {window_s:.3f} s: {n_window} flushes, "
            f"{B * n_window} frames; build_fps {e2e['build_fps']:.4f}, "
            f"flush ms p50 {np.percentile(flush_s, 50) * 1e3:.3f} p95 "
            f"{e2e['flush_ms_p95']:.4f} max {max(flush_s) * 1e3:.3f}")
    counted = {k: v - counts0.get(k, 0) for k, v in TELEMETRY.counters.items()
               if k.startswith(("detector.", "longterm."))}
    trace = tracer.result() if tracer is not None else None
    split = {}
    if trace is not None:
        split, rest = arith.kernel_split(
            (n, e - s_) for n, s_, e in trace.kernels)
        split["rest's largest"] = rest
    traced_items = n_window - traced_from if tracer is not None else 0

    # --- the check ----------------------------------------------------------
    state = mem.state
    instances = list(mem.long_memory_dict)
    n_flushes = walk.pushed // B
    del mem, perception, vitm, det, cm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, info = store_check(ctx, c, cfg, sd, walk, state, n_flushes)
    del state
    checks += check_detector(ctx, c, ref, walk, kept, instances, n_flushes,
                             info)
    info["check_s"] = round(time.perf_counter() - t_check, 3)
    info.update(marks)
    info["window_flushes"] = n_window
    info["window_counters"] = counted
    q = np.array_split(np.array(flush_s) * 1e3, min(4, n_window))
    info["flush_ms_mean_by_quarter"] = [round(float(x.mean()), 3) for x in q]
    info["traced_flushes"] = traced_items
    if split:
        info["traced_device_s_by_kind"] = split
    return Outcome(e2e=e2e, attempted=n_window, failed=0, checks=checks,
                   device=device, spans=spans, trace=trace,
                   traced_items=traced_items, window_t0=t0,
                   traced_t0=traced_t0, info=info)


def unclear_classes(emb: np.ndarray, text: np.ndarray, d: Dict,
                    margin: float) -> set:
    """The classes of one frame whose box list a tie could change: that of
    a patch whose heat lies within ``margin`` of the confidence, and, for a
    patch at or above ``confidence - margin`` whose best class leads the
    second by less than ``margin``, both (a patch further below is in no
    class's mask, whatever its best class)."""
    z = d["logit_scale"] * (emb.astype(np.float64) @ text.astype(
        np.float64).T)
    p = np.exp(z - z.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    order = np.argsort(p, axis=1)
    top, second = order[:, -1], order[:, -2]
    hv = p[np.arange(len(p)), top]
    lead = hv - p[np.arange(len(p)), second]
    near = np.abs(hv - d["confidence"]) <= margin
    tie = (lead < margin) & (hv >= d["confidence"] - margin)
    return set(top[near | tie].tolist()) | set(second[tie].tolist())


def compare_boxes(c, kept_dets: Dict[int, list], ref_dets: List[list],
                  unclear: List[set], info: Dict) -> Check:
    """``boxes_off`` over the kept batches' clear (frame, class) pairs."""
    d, B = c["detector"], c["batch"]
    tol = c["check"]["score_tol"]
    pairs = compared = off = n_boxes = 0
    for j, dets in kept_dets.items():
        for i, got in enumerate(dets):
            v = j * B + i
            for ci, name in enumerate(d["classes"]):
                pairs += 1
                if ci in unclear[v]:
                    continue
                compared += 1
                p = [(x.xyxy, x.confidence) for x in got if x.label == name]
                r = [(xyxy, cf) for lab, cf, xyxy in ref_dets[v]
                     if lab == name]
                n_boxes += len(r)
                off += (len(p) != len(r) or any(
                    a[0] != b[0] or abs(a[1] - b[1]) > tol
                    for a, b in zip(p, r)))
    fl = c["check"]
    info.update({"box_pairs": pairs, "box_pairs_compared": compared,
                 "box_pairs_off": int(off), "boxes_compared": n_boxes})
    if compared < fl["min_pairs_clear"] * pairs or n_boxes < fl["min_boxes"]:
        return Check("boxes_off", 1.0, c["limits"]["boxes_off"],
                     f"compared {compared} of {pairs} (frame, class) pairs "
                     f"and {n_boxes} boxes, under the floors")
    return Check("boxes_off", off / compared, c["limits"]["boxes_off"],
                 "share of clear (frame, class) box lists off the "
                 "reference's")


def conf_err(c):
    """The most a sound program's box confidence p may lie from the
    reference's (see the module's docstring)."""
    k = 2 * c["detector"]["logit_scale"] * c["limits"]["embed_gap"]
    slack = c["check"]["conf_slack"]
    return lambda p: k * p * (1 - p) + slack


def replay_instances(c, walk, ref_dets: List[list], unclear: List[set],
                     n_flushes: int, info: Dict):
    """The reference's long-term memory after every flush of the run
    (``metaclip.integrate``), and where it may differ from a sound
    program's (``metaclip.Unsure``): an instance from an unclear (frame,
    class) pair is tainted from the start, as its box may differ."""
    d, B = c["detector"], c["batch"]
    s, m = c["sensor"], c["memory"]
    pose0 = walk.poses[0]
    located = [metaclip.locate(ref_dets[v], walk.depth[v], walk.poses[v],
                               pose0, s, m, c["check"]["edge_m"])
               for v in range(len(walk.poses))]
    for v, xs in enumerate(located):
        for x in xs:
            x["tainted"] = d["classes"].index(x["label"]) in unclear[v]
    info["located_near_a_face"] = sum(len(x["cands"]) > 1 for xs in located
                                      for x in xs)
    unsure = metaclip.Unsure(d["dedup_l1"])
    mem: List[Dict] = []
    n_batches = len(walk.poses) // B
    for f in range(n_flushes):
        idx, _ = walk.flush(f, B)
        mem.extend(dict(x) for v in idx for x in located[v])
        if any(ref_dets[v] for v in idx):
            mem = metaclip.integrate(mem, d["dedup_l1"], conf_err(c), unsure)
        if f == n_batches - 1:
            info["instances_after_first_lap"] = len(mem)
    return mem, unsure


def compare_instances(c, got: List[Dict], want: List[Dict], info: Dict,
                      unsure: Optional["metaclip.Unsure"] = None) -> Check:
    """``instances_off``: the share of long-term instances on one side
    only or with confidences further than ``score_tol`` apart, over the
    reference's untainted slots and the program's instances.  A slot and
    a program instance of its label pair up where the program's voxel is
    one the slot's could be (its ``cands``); a program instance that pairs
    with none is left out where it lies within the merge distance of a
    place ``unsure`` holds for its label."""
    tol = c["check"]["score_tol"]
    p = {(x["label"], tuple(x["loc"])): x["confidence"] for x in got}
    r = [x for x in want if not x.get("tainted")]
    paired, off = set(), 0
    for x in r:
        key = next((k for k in ((x["label"], tuple(v)) for v in
                                x.get("cands", [x["loc"]]))
                    if k in p and k not in paired), None)
        if key is None:
            off += 1
            continue
        paired.add(key)
        off += abs(p[key] - x["confidence"]) > tol
    rest = [k for k in p if k not in paired]
    excused = sum(unsure is not None and unsure.touches(k[0], [k[1]])
                  for k in rest)
    off += len(rest) - excused
    union = len(r) + len(rest) - excused
    info.update({"instances_program": len(got),
                 "instances_reference": len(want),
                 "instances_compared": len(r),
                 "instances_tainted": len(want) - len(r),
                 "instances_program_excused": excused,
                 "instances_one_side": len(r) - len(paired)
                 + len(rest) - excused})
    if len(r) < c["check"]["min_instances"]:
        return Check("instances_off", 1.0, c["limits"]["instances_off"],
                     f"compared {len(r)} of the reference's instances, "
                     "under the floor")
    return Check("instances_off", off / union,
                 c["limits"]["instances_off"],
                 "share of long-term instances off the reference's")


def shifted(instances: List[Dict]) -> List[Dict]:
    """The planted fault: each instance moved by one voxel along x."""
    return [dict(x, loc=[x["loc"][0] + 1, *x["loc"][1:]]) for x in instances]


def check_detector(ctx, c, ref: Reference, walk, kept: Kept,
                   instances: List[Dict], n_flushes: int,
                   info: Dict) -> List[Check]:
    d, B = c["detector"], c["batch"]
    s = c["sensor"]
    t = time.perf_counter()
    text, emb = ref.text.numpy(), ref.embeddings(B, ctx.device)
    info["class_term_scale"] = ref.scale
    info["clip_draw"] = ref.draw
    info["check_detector_embed_s"] = round(time.perf_counter() - t, 3)
    gaps = [float(np.linalg.norm(e - emb[j * B:(j + 1) * B], axis=-1).max())
            for j, e in kept.emb.items()]
    info["embed_batches_compared"] = len(gaps)
    gap = Check("embed_gap", max(gaps) if gaps else float("inf"),
                c["limits"]["embed_gap"],
                "largest L2 distance between the program's unit patch "
                "embeddings and the reference's")
    ref_dets = [metaclip.boxes(emb[v], text, d, s["height"], s["width"])
                for v in range(len(emb))]
    unclear = [unclear_classes(emb[v], text, d, c["check"]["heat_margin"])
               for v in range(len(emb))]
    n_ref = [len(x) for x in ref_dets]
    info.update({"ref_frames_with_box": float(np.mean([n > 0 for n in n_ref])),
                 "ref_boxes_a_frame": float(np.mean(n_ref)),
                 "ref_pairs_clear": 1.0 - sum(map(len, unclear)) / (
                     len(emb) * len(d["classes"]))})
    boxes = compare_boxes(c, kept.dets, ref_dets, unclear, info)
    want, unsure = replay_instances(c, walk, ref_dets, unclear, n_flushes,
                                    info)
    inst = compare_instances(c, instances, want, info, unsure)
    info["instances_tainted_share"] = (info["instances_tainted"]
                                       / max(1, info["instances_reference"]))
    info["instances_off_shifted"] = compare_instances(
        c, shifted(instances), want, {}, unsure).value
    info["check_detector_s"] = round(time.perf_counter() - t, 3)
    return [gap, boxes, inst]
