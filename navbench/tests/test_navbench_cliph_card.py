"""On the card, for ``build.cliph-b8``: a short sound run is correct over
at least the configuration's floors of boxes and instances, and the
control (the int8 W8A8 ViT-L and the int8 W8A8 CLIP vision tower) is not,
its ``embed_gap`` over the limit; and the memory build's replayed ViT-L
graph and the eager detector share one flush without disturbing each
other.  Run on a machine with a card:
``python3 -m pytest -m cuda navbench/tests/test_navbench_cliph_card.py``."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from navbench import run as R

CELL = "build.cliph-b8"


def _run(seed: int, control: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "navbench", "--workload", CELL, "--seed",
         str(seed), "--seconds", "10", "--trace", "0", "--control",
         str(control)], cwd=R.ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    info = {}
    for ln in proc.stderr.splitlines():
        if ln.startswith("[navbench] ") and ": " in ln:
            k, v = ln[len("[navbench] "):].split(": ", 1)
            info[k] = v
    return json.loads(proc.stdout.strip().splitlines()[-1]) | {"info": info}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cliph_sound_run_is_correct_over_its_floors(card):
    line = _run(2 ** 31 + 2026, 0)
    assert line["correct"], line["checks"]
    c = R.load_json(R.ROOT / "navbench" / "configs"
                    / "habitat-dinov2l-cliph.json")
    info = line["info"]
    assert int(info["boxes_compared"]) >= c["check"]["min_boxes"]
    assert int(info["instances_compared"]) >= c["check"]["min_instances"]
    assert int(info["embed_batches_compared"]) == 12


@pytest.mark.cuda
def test_cliph_control_is_not_correct(card):
    line = _run(2 ** 31 + 2027, 1)
    assert not line["correct"]
    gap = line["checks"]["embed_gap"]
    assert gap["value"] > gap["limit"], gap


@pytest.mark.cuda
def test_graphed_encode_and_eager_detector_share_a_flush(card, monkeypatch):
    """Tiny models on the card, three flushes of 8 frames: with the
    detector the ViT-L encode is still captured once and replayed, its
    patch grids equal those of the build without a detector bit for bit,
    and each flush's detector embeddings equal the detector's own on the
    same frames alone."""
    from bsc_nav_tpu_torch.agents.spatial_memory import (
        Perception, VoxelTokenMemory)
    from bsc_nav_tpu_torch.memory import pipeline
    from bsc_nav_tpu_torch.models import clip as C
    from bsc_nav_tpu_torch.models import vit
    from bsc_nav_tpu_torch.models.detector import ClipPatchDetector
    from bsc_nav_tpu_torch.models.tokenizer import HashTokenizer
    from bsc_nav_tpu_torch.utils.profiling import TELEMETRY
    from navbench import scene
    from navbench import weights as W
    from navbench import weights_clip as WC
    from navbench.drivers import memory_build as MB
    from navbench.drivers import memory_build_cliph as D
    from navbench.tests import tiny

    c = tiny.config("habitat-dinov2l-cliph")
    c["detector"].update(
        embed_dim=32, image_size=32, patch_size=4, vision_width=64,
        vision_layers=2, vision_heads=2, vision_mlp=256, context_length=16,
        vocab_size=512, text_width=64, text_heads=2, text_layers=2,
        text_mlp=256)
    d, s = c["detector"], c["sensor"]
    t = tiny.traffic("room-patrol-cliph")
    poses = scene.bank_poses(t)[:24]
    rgb, depth = scene.render(poses, t, 5, s["height"], s["width"],
                              s["hfov_deg"], s["sensor_height"], "cuda")
    vcfg = MB.vit_config(c["encoder"])
    wv = W.draw(W.dinov2_specs(c["encoder"]), 3, "cuda")
    ccfg = D.clip_config(d)
    cm = C.CLIP(ccfg, device="cuda")
    cm.load_state_dict(WC.draw(d, 21, 22, "cuda", scale=8.0), strict=True)
    grids = []
    encode = pipeline.encode_patch_grid

    def keep_grid(*a, **k):
        out = encode(*a, **k)
        grids[-1].append(out.clone())
        return out

    monkeypatch.setattr(pipeline, "encode_patch_grid", keep_grid)

    def build(det):
        grids.append([])
        cfg = MB.program_config(c, 0, False)
        vm = vit.ViT(vcfg, dtype=torch.bfloat16, device="cuda")
        vm.load_state_dict(wv, strict=True)
        perception = Perception.create(cfg, vit_cfg=vcfg, vit_params=vm,
                                       batch_size=8,
                                       compute_dtype=torch.bfloat16,
                                       device="cuda")
        mem = VoxelTokenMemory(cfg, None, perception, detector=det)
        before = dict(TELEMETRY.counters)
        for i in range(len(poses)):
            mem.push_frame({"rgb": rgb[i], "depth": depth[i]}, poses[i])
        torch.cuda.synchronize()
        return {k: TELEMETRY.counters.get(k, 0) - before.get(k, 0)
                for k in ("encode.graph_captures", "encode.graph_replays")}

    det = ClipPatchDetector(
        cm, ccfg, HashTokenizer(vocab_size=d["vocab_size"],
                                context_length=d["context_length"]),
        d["classes"], d["confidence"], device="cuda")
    embs = []

    def keep_embed(frames):
        out = ClipPatchDetector.embed(det, frames)
        embs.append(out)
        return out

    det.embed = keep_embed
    assert build(None) == build(det) == {"encode.graph_captures": 1,
                                         "encode.graph_replays": 2}
    assert len(grids[0]) == len(grids[1]) == 3
    for plain, with_det in zip(*grids):
        assert torch.equal(plain, with_det)
    assert len(embs) == 3
    for f, got in enumerate(embs):
        np.testing.assert_array_equal(
            got, ClipPatchDetector.embed(det, rgb[8 * f:8 * f + 8]))
