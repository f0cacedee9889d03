"""Port parity: the profiling subsystem (``bsc_nav_tpu_torch/utils/
profiling.py``) against ``bsc_nav_tpu/utils/profiling.py``: the Stopwatch's
stats and report on the same samples, the Telemetry gauges and dump on
equal stores; the trace writes a Chrome trace; ``device_kernels`` moved
here from the package's root."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bsc_nav_tpu.config import small_test_config as jsmall
from bsc_nav_tpu.memory.store import init_store as jinit_store
from bsc_nav_tpu.utils import profiling as JP
from bsc_nav_tpu_torch.config import small_test_config
from bsc_nav_tpu_torch.memory.store import init_store
from bsc_nav_tpu_torch.utils import profiling as TP


def test_stopwatch_stats_and_report_equal_jax():
    rng = np.random.default_rng(0)
    samples = {"ingest": rng.uniform(1e-4, 0.2, 17).tolist(),
               "query": rng.uniform(1e-3, 2.0, 5).tolist(),
               "a/b": [0.5]}
    jw, tw = JP.Stopwatch(), TP.Stopwatch()
    for w in (jw, tw):
        for k, v in samples.items():
            w.samples[k].extend(v)
    assert tw.as_dict() == jw.as_dict()
    assert tw.report() == jw.report()
    assert tw.stats("missing") == jw.stats("missing") == {}
    # scopes record one sample each, nested too
    with tw("outer"):
        with tw("inner") as h:
            h["result"] = (torch.ones(3), {"x": 1})
    assert tw.stats("outer")["count"] == tw.stats("inner")["count"] == 1
    assert tw.samples["outer"][0] >= tw.samples["inner"][0]


def test_stopwatch_sync_waits_for_the_result_s_device(monkeypatch):
    """sync=True synchronises the device of the first tensor leaf handed
    to ``holder["result"]``, and nothing for a CPU result."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    sw = TP.Stopwatch(sync=True)
    with sw("cpu") as h:
        h["result"] = [torch.zeros(2)]
    assert synced == []

    class OnCard:
        is_cuda, device = True, torch.device("cuda", 0)
    with sw("card") as h:
        h["result"] = ({"k": OnCard()}, torch.zeros(1))
    assert synced == [torch.device("cuda", 0)]
    assert len(sw.samples["card"]) == 1


@pytest.mark.parametrize("n", [0, 7])
def test_telemetry_equal_on_equal_stores(tmp_path, n):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 5, size=n).astype(np.int32)
    js = jinit_store(jsmall().memory)
    js = js.replace(num_voxels=jnp.asarray(n, jnp.int32),
                    feat_count=js.feat_count.at[:n].set(jnp.asarray(counts)),
                    dropped_voxels=jnp.asarray(3, jnp.int32))
    ts = init_store(small_test_config().memory, device="cpu")
    ts.num_voxels.fill_(n)
    ts.feat_count[:n] = torch.from_numpy(counts)
    ts.dropped_voxels.fill_(3)
    jt, tt = JP.Telemetry(), TP.Telemetry()
    for t, s in ((jt, js), (tt, ts)):
        t.count("queries")
        t.count("queries", 2.5)
        t.gauge("fps", 12)
        t.memory_stats(s)
        t.dump(str(tmp_path / type(t).__module__ / "t.json"),
               extra={"run": "test"})
    assert tt.gauges == jt.gauges and dict(tt.counters) == dict(jt.counters)
    assert tt.gauges["memory/total_tokens"] == float(counts.sum())
    files = [open(tmp_path / m.__name__ / "t.json").read() for m in (JP, TP)]
    assert files[0] == files[1]
    assert json.loads(files[1])["run"] == "test"


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    with TP.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert str(path) in capsys.readouterr().out


def test_device_kernels_lives_in_utils():
    import bsc_nav_tpu_torch
    assert callable(TP.device_kernels)
    assert not os.path.exists(os.path.join(
        os.path.dirname(bsc_nav_tpu_torch.__file__), "profiling.py"))
