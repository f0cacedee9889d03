"""The yardstick's arithmetic against hand-worked cases and a synthetic
trace."""

from __future__ import annotations

import math

import pytest

from navbench import arith
from navbench.harness import Outcome, Spans, Trace
from navbench.metrics import _build_shapes as S
from navbench import run as R
from navbench.tests import tiny


def test_bound_and_attention_counts():
    assert arith.attn_flops(1, 1, 2, 3, 4) == 4 * 2 * 3 * 4
    assert arith.attn_bytes(1, 2, 3, 5, 4, 2) == 2 * 2 * 4 * (6 + 10)
    t, by = arith.bound(989e12, 1.0, "bf16")
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = arith.bound(1.0, 3.35e12, "int8")
    assert by == "bytes" and t == pytest.approx(1.0)
    assert arith.PEAK_OPS["f32"] == pytest.approx(165e12)


def test_k1_call_by_hand():
    """B 8, S 261, 16 x 64 bf16: 17.1 MB of q, k, v and out at 3.35 TB/s
    outweigh 2.23 GFLOP at 989 TFLOP/s."""
    c = tiny.config()
    c["encoder"].update(img_size=224, dim=1024, heads=16)
    c["query"].update(query_width=224)
    flops = 4 * 8 * 16 * 261 * 261 * 64
    n_bytes = 2 * 8 * 16 * 64 * 4 * 261
    assert S.k1_call_s(c) == pytest.approx(max(flops / 989e12,
                                               n_bytes / 3.35e12))
    assert n_bytes / 3.35e12 > flops / 989e12


def test_busy_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert arith.busy_seconds(iv) == pytest.approx(3.0)
    assert arith.idle_gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert arith.idle_gaps([], 1.0, 2.0) == [(1.0, 2.0)]
    assert arith.share_percent(1.0, 0.0) is None
    assert arith.share_percent(1.0, 4.0) == 25.0


def test_kernel_split():
    split, rest = arith.kernel_split([
        ("void attention_wgmma_kernel<short_attention_qkv>", 1.0),
        ("sm90_xmma_gemm_bf16", 2.0), ("elementwise_kernel", 0.5)])
    assert split["K1/K3 attention"] == 1.0 and split["GEMMs"] == 2.0
    assert rest == [("elementwise_kernel", 0.5)]


def synthetic(traced_items=2):
    """A traced window of 1 s: K1 0.1 s, a GEMM 0.3 s, another kernel
    0.2 s overlapping the GEMM by 0.1 s, idle 0.5 s; host spans."""
    tr = Trace(kernels=[("attention_wgmma_kernel<x>", 10.0, 10.1),
                        ("elementwise_kernel<y>", 10.2, 10.4),
                        ("sgemm_128x64", 10.3, 10.6)],
               spans=[("encode_ingest", 10.0, 10.5), ("flush", 9.9, 11.0)],
               lo=10.0, hi=11.0)
    spans = Spans()
    spans.items["flush"] = [(0.0, 0.030), (1.0, 1.050), (2.0, 2.5)]
    spans.items["encode_ingest"] = [(0.005, 0.020), (1.01, 1.04),
                                    (2.1, 2.2)]
    out = Outcome(e2e={}, attempted=1, failed=0, checks=[], device={},
                  spans=spans, trace=tr, traced_items=traced_items,
                  window_t0=0.0, traced_t0=2.0)
    return out


def test_trace_readers_on_a_synthetic_window():
    out = synthetic()
    ctx = tiny.ctx()
    assert out.trace.busy_s() == pytest.approx(0.5)
    idle = R.metric_reader("idle_share.build")(out, ctx)
    assert idle == pytest.approx(50.0)
    k1 = R.metric_reader("k1_roofline.build")(out, ctx)
    calls = 2 * ctx.config["encoder"]["depth"]
    assert k1 == pytest.approx(100 * calls * S.k1_call_s(ctx.config) / 0.1)
    mfu = R.metric_reader("mfu.build")(out, ctx)
    assert mfu == pytest.approx(100 * 2 * S.flush_least_s(ctx.config) / 1.0)
    bd = out.trace.breakdown()
    assert bd["device_ops"][0] == ["sgemm_128x64", pytest.approx(0.3)]
    assert bd["idle_gaps"][0] == ["flush", pytest.approx(0.4)]
    assert bd["idle_gaps"][1] == ["encode_ingest", pytest.approx(0.1)]


def test_span_readers_take_the_untraced_flushes():
    """Flushes of 30 and 50 ms before the traced part (the third is
    traced), with 15 and 30 ms of encode and ingest inside."""
    out = synthetic()
    ctx = tiny.ctx()
    enc = R.metric_reader("encode_ingest_ms.build")(out, ctx)
    assert enc == pytest.approx(22.5)
    agent = R.metric_reader("agent_ms.build")(out, ctx)
    assert agent == pytest.approx(40.0 - 22.5)


def test_readers_report_nothing_without_a_trace():
    out = synthetic(traced_items=0)
    ctx = tiny.ctx()
    for name in ("k1_roofline.build", "mfu.build"):
        assert R.metric_reader(name)(out, ctx) is None
    out.trace = None
    assert R.metric_reader("idle_share.build")(out, ctx) is None
    out.spans = Spans()
    assert R.metric_reader("agent_ms.build")(out, ctx) is None


def test_flush_least_time_by_hand():
    """ViT-L at the configuration's widths, B 8: 24 blocks of 12 D^2
    multiply-adds a token over 8 x 261 tokens, in bf16, and the attention
    at K1's bound; in f32 the same operations at 165 TFLOP/s."""
    c = tiny.config()
    c["encoder"].update(img_size=224, dim=1024, depth=24, heads=16)
    c["query"].update(query_width=224)
    T, D = 8 * 261, 1024
    flops = 24 * 2 * T * 12 * D * D + 2 * 8 * 256 * 588 * D
    assert S.flush_least_s(c) == pytest.approx(flops / 989e12
                                               + 24 * S.k1_call_s(c))
    c["encoder"]["dtype"] = "float32"
    assert S.flush_least_s(c) == pytest.approx(flops / 165e12
                                               + 24 * S.k1_call_s(c))
    assert math.isfinite(S.flush_least_s(tiny.config()))
