"""A whole run at a tiny size on the CPU, the card's look skipped: sound,
it comes out correct under the configuration's limits; with the timed
path broken underneath, correct comes out false, once for each fault
the cell can have (one card: no exchange between cards to leave out)."""

from __future__ import annotations

import json

import pytest

from navbench import run as R
from navbench.drivers import memory_build
from navbench.tests import tiny


def result(**kw):
    ctx = tiny.ctx(seconds=0.6, **kw)
    ctx.cell = {"name": "build.dinov2l-b8", "chips": 1}
    out = memory_build.run(ctx)
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    line = R.result_line(ctx, bench, out)
    json.dumps(line)
    return line


def test_sound_run_is_correct():
    line = result(seed=2 ** 31 + 5)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["metrics"]["build_fps"]["value"] > 0


def _ingest_unchanged(state, *a, **k):
    return state, {}


def _half_batch(ingest):
    def f(state, rgb, depth, poses, tokens, gen, cfg, **k):
        depth = depth.clone()
        depth[depth.shape[0] // 2:] = 0      # their points all fail the gate
        return ingest(state, rgb, depth, poses, tokens, gen, cfg, **k)
    return f


def _token_altered(encode):
    def f(*a, **k):
        out = encode(*a, **k)
        out = out.clone()
        out[0] = -out[0]                     # the batch's first frame
        return out
    return f


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    from bsc_nav_tpu_torch.memory import pipeline
    if fault == "state_unchanged":
        monkeypatch.setattr(pipeline, "ingest_frames", _ingest_unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(pipeline, "ingest_frames",
                            _half_batch(pipeline.ingest_frames))
    else:
        monkeypatch.setattr(pipeline, "encode_patch_grid",
                            _token_altered(pipeline.encode_patch_grid))
    line = result(seed=11)
    assert not line["correct"], line["checks"]
