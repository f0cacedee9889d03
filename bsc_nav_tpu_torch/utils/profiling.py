"""Tracing / profiling subsystem.

Counterpart of ``bsc_nav_tpu/utils/profiling.py``:

  - Stopwatch: named, nestable wall-clock scopes with aggregated stats
    (count / total / mean / p50 / p95) and optional device sync, so that
    timings of asynchronous CUDA work are real;
  - trace(): context manager around torch.profiler writing a Chrome trace;
  - Telemetry: structured counters (the reference's printed token counts
    become queryable metrics), dumped as one json blob per run;
  - device_kernels(): the names of the device kernels a call launches,
    from one profiled window (how the card tests check the tile each
    attention kernel took).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


def _first_leaf(x):
    """First tensor leaf of a result (tuple/list/dict/tensor)."""
    if isinstance(x, (tuple, list)):
        for item in x:
            leaf = _first_leaf(item)
            if leaf is not None:
                return leaf
        return None
    if isinstance(x, dict):
        for item in x.values():
            leaf = _first_leaf(item)
            if leaf is not None:
                return leaf
        return None
    return x


class Stopwatch:
    """Named wall-clock scopes with aggregation.

        sw = Stopwatch(sync=True)
        with sw("ingest") as h:
            h["result"] = memory.flush()
        print(sw.report())
    """

    def __init__(self, sync: bool = False):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str):
        """sync=True: assign the computation's output to
        ``holder["result"]`` inside the block; the scope then ends after
        ``torch.cuda.synchronize`` on the device of its first tensor leaf
        (CUDA launches return before the device finishes).  A result on
        the CPU, or none, ends the scope at once."""
        t0 = time.perf_counter()
        holder: Dict[str, object] = {"result": None}
        try:
            yield holder
        finally:
            leaf = _first_leaf(holder.get("result")) if self.sync else None
            if getattr(leaf, "is_cuda", False):
                torch.cuda.synchronize(leaf.device)
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self, name: str) -> Dict[str, float]:
        s = np.asarray(self.samples.get(name, []), float)
        if len(s) == 0:
            return {}
        return {
            "count": int(len(s)),
            "total_s": float(s.sum()),
            "mean_ms": float(s.mean() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p95_ms": float(np.percentile(s, 95) * 1e3),
        }

    def report(self) -> str:
        lines = []
        for name in sorted(self.samples):
            st = self.stats(name)
            lines.append(
                f"{name:<28} n={st['count']:<5} total={st['total_s']:.2f}s "
                f"mean={st['mean_ms']:.2f}ms p50={st['p50_ms']:.2f}ms "
                f"p95={st['p95_ms']:.2f}ms")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: self.stats(k) for k in self.samples}


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the block (host and, where there is a
    card, device activity), written as a Chrome trace
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    print(f"torch trace written to {path}")


class Telemetry:
    """Structured run counters + gauges (json-dumpable)."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def memory_stats(self, state) -> None:
        """Snapshot voxel-store occupancy (replaces the reference's HDF5
        token-count scan, memory_2.py:312-323)."""
        n = int(state.num_voxels)
        counts = state.feat_count[:n].cpu().numpy()
        self.gauge("memory/num_voxels", n)
        self.gauge("memory/total_tokens", float(counts.sum()))
        self.gauge("memory/mean_tokens_per_voxel",
                   float(counts.mean()) if n else 0.0)
        self.gauge("memory/dropped_voxels", int(state.dropped_voxels))

    def dump(self, path: str, extra: Optional[Dict] = None) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"counters": dict(self.counters),
                       "gauges": self.gauges, **(extra or {})}, f, indent=2)


def device_kernels(fn) -> list:
    """Names of the device kernels that fn() launches, from one profiled
    window, which opens with a kernel of its own: a fill of one element,
    whose name is among those returned when the profiler keeps it.  On the
    H100 the profiler has dropped the first kernel of a window (late in a
    long process, window after window, with CUPTI torn down after each
    window or kept), so that a window around a call of one kernel came
    back empty; it drops the fill instead."""
    from torch.profiler import ProfilerActivity, profile
    first = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        first.fill_(0)
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
