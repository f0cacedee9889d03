"""The port's tracing of the memory build (``bsc_nav_tpu_torch/utils/
profiling.py``): the spans a flush records, their parents and flush ids,
the ring's capacity, the ``record_function`` ranges under a profiler and
their place on its clock, the ingest's device counters against the
benchmark's reference replay, and the per-layer readers that read the
spans (``navbench/metrics/``), on tiny runs on the CPU."""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch

from bsc_nav_tpu_torch.agents.spatial_memory import (
    Perception, VoxelTokenMemory)
from bsc_nav_tpu_torch.config import small_test_config
from bsc_nav_tpu_torch.models import vit
from bsc_nav_tpu_torch.utils import profiling as TP

FLUSH_CHILDREN = ("memory.stage", "memory.h2d", "perception.encode",
                  "perception.ingest")
READERS = ("stage_ms.build", "h2d_gbps.build", "encode_ms.build",
           "ingest_ms.build", "agent_idle_ms.build", "encode_idle_ms.build",
           "ingest_idle_ms.build")
IDLE_READERS = READERS[4:]
CLOCK_TOL_S = 200e-6


def _frames(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    H, W = cfg.sensor.height, cfg.sensor.width
    for i in range(n):
        obs = {"rgb": rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
               "depth": rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)}
        yaw = 0.3 * i
        pose = np.array([0.1 * i, 0.0, 0.0, 0.0, math.sin(yaw / 2), 0.0,
                         math.cos(yaw / 2)], np.float32)
        yield obs, pose


@pytest.fixture(scope="module")
def tiny_build():
    """Ten frames pushed at B 4 (two flushes by push, one short flush by
    hand): the records, host counters and device counters it added."""
    cfg = small_test_config()
    vcfg = vit.ViTConfig(img_size=28, patch_size=14, dim=32, depth=1,
                         heads=2, num_registers=0)
    perception = Perception.create(cfg, vit_cfg=vcfg, batch_size=4,
                                   device="cpu")
    mem = VoxelTokenMemory(cfg, None, perception)
    before = TP.TELEMETRY.snapshot()
    t0 = time.perf_counter()
    for obs, pose in _frames(cfg, 10):
        mem.push_frame(obs, pose)
    mem.flush()
    recs = [r for r in TP.SPANS.records if r.start >= t0]
    after = TP.TELEMETRY.snapshot()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    return cfg, mem, recs, delta


def test_each_flush_records_its_spans(tiny_build):
    cfg, _, recs, _ = tiny_build
    flushes = [r for r in recs if r.name == "memory.flush"]
    assert len(flushes) == 3
    assert len({r.flush for r in flushes}) == 3
    for f in flushes:
        kids = sorted((r for r in recs if r.parent == f.id),
                      key=lambda r: r.start)
        assert [r.name for r in kids] == list(FLUSH_CHILDREN)
        for k in kids:
            assert k.flush == f.flush
            assert f.start <= k.start <= k.end <= f.end
    pushes = [r for r in recs if r.name == "memory.push"]
    assert len(pushes) == 10
    # the batch's last push holds its flush; the pushes share its id
    by_id = {r.id: r for r in recs}
    for f in flushes[:2]:
        assert by_id[f.parent].name == "memory.push"
        assert sum(p.flush == f.flush for p in pushes) == 4
    assert flushes[2].parent == -1          # flushed by hand
    assert sum(p.flush == flushes[2].flush for p in pushes) == 2


def test_h2d_carries_the_batch_bytes(tiny_build):
    cfg, _, recs, delta = tiny_build
    H, W = cfg.sensor.height, cfg.sensor.width
    nbytes = 4 * (H * W * 3 + H * W * 4 + 7 * 4)
    h2d = [r for r in recs if r.name == "memory.h2d"]
    assert [r.count for r in h2d] == [nbytes] * 3
    assert all(r.count is None for r in recs if r.name != "memory.h2d")
    assert delta["memory.h2d_bytes"] == 3 * nbytes
    assert delta["memory.frames_pushed"] == 10
    assert delta["memory.frames_padded"] == 2
    assert delta["memory.flushes"] == 3


def test_device_counters_sum_the_ingest(tiny_build):
    """Three batches of 4 frames: every drawn point is gated, appended,
    replaces a row or is dropped; the voxels added are the store's."""
    cfg, mem, _, d = tiny_build
    P = -(-cfg.sensor.height * cfg.sensor.width
          // cfg.memory.depth_sample_rate)
    assert d["ingest.points_drawn"] == 3 * 4 * P
    assert d["ingest.voxels_added"] == int(mem.state.num_voxels) > 0
    assert d["ingest.rows_appended"] == int(mem.state.feat_count.sum())
    assert (d["ingest.points_gated"] + d["ingest.rows_appended"]
            + d["ingest.rows_replaced"] + d["ingest.points_dropped_full"]
            == d["ingest.points_drawn"])
    # the two padded frames' points all fail the depth gate; the tiny
    # store fills, and the points of its later new voxels are dropped
    assert d["ingest.points_gated"] >= 2 * P
    assert int(mem.state.dropped_voxels) > 0
    assert d["ingest.points_dropped_full"] >= int(mem.state.dropped_voxels)


def test_a_full_store_counts_its_drops():
    """A store of 40 voxels takes its first 40 new voxels; the points of
    the rest are dropped, and every drawn point is counted once."""
    from bsc_nav_tpu_torch.memory import ingest, store
    cfg = small_test_config()
    cfg = cfg.replace(memory=dataclasses.replace(cfg.memory,
                                                 voxel_capacity=40))
    state = store.init_store(cfg.memory, device="cpu")
    frames = list(_frames(cfg, 2, seed=3))
    rgb, depth, poses = (torch.from_numpy(np.stack(x)) for x in (
        [f[0]["rgb"] for f in frames], [f[0]["depth"] for f in frames],
        [f[1] for f in frames]))
    tokens = torch.randn(2, 2, 2, cfg.memory.token_dim)
    state, stats = ingest.ingest_frames(
        state, rgb, depth, poses, tokens, torch.Generator().manual_seed(0),
        cfg)
    tel = TP.Telemetry()
    tel.count_ingest(stats)
    snap = tel.snapshot()
    assert snap["ingest.voxels_added"] == 40 == int(state.num_voxels)
    assert snap["ingest.points_dropped_full"] > 0
    assert (snap["ingest.points_gated"] + snap["ingest.points_dropped_full"]
            + int(stats["points_valid"]) == snap["ingest.points_drawn"])


def test_counters_snapshot_and_dump(tmp_path):
    tel = TP.Telemetry()
    one = {k: torch.tensor(i + 1) for i, k in enumerate(TP.INGEST_COUNTERS)}
    tel.count_ingest(one)
    tel.count_ingest(one)
    tel.count_ingest({"points_valid": torch.tensor(5)})   # no counts
    tel.count_ingest(None)
    tel.count("memory.flushes", 2)
    snap = tel.snapshot()
    assert snap["memory.flushes"] == 2
    for i, k in enumerate(TP.INGEST_COUNTERS):
        assert snap[f"ingest.{k}"] == 2 * (i + 1)
    tel.dump(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json"))["counters"] == snap


def test_ring_keeps_its_capacity():
    sw = TP.Stopwatch()
    for _ in range(TP.CAPACITY + 10):
        with sw("s"):
            pass
    assert len(sw.records) == TP.CAPACITY
    assert sw.records[0].id == 10
    assert sw.stats("s")["count"] == TP.CAPACITY


def test_ranges_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    sw = TP.Stopwatch()
    with sw("outer"):
        with sw("inner"):
            pass
    assert opened == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with sw("outer"):
            with sw("inner"):
                torch.ones(4) + 1
    assert opened == ["outer", "inner"]
    names = [e.name for e in prof.events()]
    assert "outer" in names and "inner" in names
    inner, outer = sw.records[-2], sw.records[-1]
    assert inner.parent == outer.id and outer.parent == -1


# ---------------------------------------------------------------------------
# a tiny traced run of the benchmark's memory build
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_run():
    from navbench import harness
    from navbench import run as R
    from navbench.drivers import memory_build
    from navbench.tests import tiny

    class Capture(harness.Tracer):
        events = None

        def result(self):
            Capture.events = [
                (e.name(), e.start_ns() * 1e-9)
                for e in self.prof.profiler.kineto_results.events()]
            return super().result()

    before = TP.TELEMETRY.snapshot()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(memory_build, "Tracer", Capture)
        ctx = tiny.ctx(seconds=0.8, seed=2 ** 31 + 11, trace=True)
        ctx.cell = {"name": "build.dinov2l-b8", "chips": 1}
        out = memory_build.run(ctx)
    after = TP.TELEMETRY.snapshot()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    return out, ctx, Capture.events, delta, R


def test_tiny_traced_run_is_correct(traced_run):
    out, *_ = traced_run
    assert out.correct and out.traced_items > 0


def test_device_counters_match_the_reference_replay(traced_run):
    """The counts the check's replay makes, against the device counters
    over the run (its warm-up and window), within the points the reference
    marks unsure."""
    out, _, _, d, _ = traced_run
    tol = out.info["voxels_unsure"]
    for ours, ref in (("ingest.voxels_added", "store_voxels_added"),
                      ("ingest.rows_replaced", "store_points_replaced"),
                      ("ingest.points_dropped_full",
                       "store_points_dropped_full"),
                      ("ingest.points_gated", "store_points_gated"),
                      ("ingest.points_drawn", "store_points_drawn")):
        assert abs(d[ours] - out.info[ref]) <= tol, (ours, d[ours],
                                                     out.info[ref])


def test_spans_land_on_the_profiler_clock(traced_run):
    """Each program span inside the traced window is a range of its name
    in the profile, and the mapping puts its start within 200 us of the
    range's."""
    from navbench.metrics import _program_spans as PS
    out, _, events, _, _ = traced_run
    spans = PS.mapped(out)
    assert spans
    lo, hi = out.trace.lo, out.trace.hi
    for name in ("memory.flush",) + FLUSH_CHILDREN:
        ours = sorted(s for s, e, n, _ in spans
                      if n == name and lo <= s and e <= hi)
        prof = sorted(t for n, t in events if n == name and lo <= t <= hi)
        assert ours and len(ours) == len(prof), name
        gap = np.abs(np.array(ours) - np.array(prof)).max()
        assert gap <= CLOCK_TOL_S, (name, gap)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_a_finite_number(traced_run, name):
    out, ctx, _, _, R = traced_run
    v = R.metric_reader(name)(out, ctx)
    assert v is not None and math.isfinite(v) and v >= 0


def test_split_readers_fit_inside_the_old_ones(traced_run):
    out, ctx, _, _, R = traced_run
    read = {n: R.metric_reader(n)(out, ctx) for n in
            ("encode_ms.build", "ingest_ms.build", "encode_ingest_ms.build",
             "stage_ms.build", "agent_ms.build")}
    assert (read["encode_ms.build"] + read["ingest_ms.build"]
            <= read["encode_ingest_ms.build"])
    assert read["stage_ms.build"] <= read["agent_ms.build"]


def test_idle_readers_sum_within_the_window_s_idle(traced_run):
    out, ctx, _, _, R = traced_run
    total = sum(R.metric_reader(n)(out, ctx) for n in IDLE_READERS)
    idle = out.trace.window_s - out.trace.busy_s()
    assert 0 < total <= 1e3 * idle / out.traced_items + 1e-9


def test_readers_report_nothing_without_program_spans(traced_run,
                                                      monkeypatch):
    from navbench.metrics import _program_spans as PS
    out, ctx, _, _, R = traced_run
    monkeypatch.setattr(PS, "records", lambda: None)
    for name in READERS:
        assert R.metric_reader(name)(out, ctx) is None, name


def test_idle_goes_to_the_innermost_span(monkeypatch):
    """A synthetic traced flush on a clock 100 s ahead of perf_counter:
    the flush 0-10 ms holds encode 1-4 and ingest 4-8; the device is busy
    at 2-3 and 5-9 ms.  Idle: encode 1-2 and 3-4 ms, ingest 4-5 ms, agent
    0-1 and 9-10 ms (the flush's own time); 10-12 ms lies under no program
    span."""
    from navbench.harness import Outcome, Spans, Trace
    from navbench.metrics import _program_spans as PS

    ms = 1e-3
    S = TP.Span
    recs = [S("perception.encode", 1 * ms, 4 * ms, 0, 0, None, 1),
            S("perception.ingest", 4 * ms, 8 * ms, 0, 0, None, 2),
            S("memory.flush", 0.0, 10 * ms, -1, 0, None, 0)]
    monkeypatch.setattr(PS, "records", lambda: recs)
    spans = Spans()
    spans.items["flush"] = [(0.0, 10 * ms)]
    tr = Trace(kernels=[("k", 100 + 2 * ms, 100 + 3 * ms),
                        ("k", 100 + 5 * ms, 100 + 9 * ms)],
               spans=[("flush", 100.0, 100 + 10 * ms)],
               lo=100.0, hi=100 + 12 * ms)
    out = Outcome(e2e={}, attempted=1, failed=0, checks=[], device={},
                  spans=spans, trace=tr, traced_items=1, window_t0=0.0,
                  traced_t0=0.0)
    got = PS.idle_by_layer(out)
    assert sorted(got) == ["agent", "encode", "ingest"]
    assert got["encode"] == pytest.approx(2 * ms)
    assert got["ingest"] == pytest.approx(1 * ms)
    assert got["agent"] == pytest.approx(2 * ms)
    assert PS.idle_ms(out, "agent") == pytest.approx(2.0)
