"""Tracing / profiling subsystem.

Counterpart of ``bsc_nav_tpu/utils/profiling.py``, and the port's own
tracing:

  - Stopwatch: named, nestable wall-clock scopes with aggregated stats
    (count / total / mean / p50 / p95) and optional device sync, so that
    timings of asynchronous CUDA work are real.  Each scope is also a
    span record (``Span``) in a ring of ``CAPACITY``; while a
    ``torch.profiler`` is active each scope is a ``record_function`` range
    of its own name too, so a Chrome trace shows it over its kernels;
  - trace(): context manager around torch.profiler writing a Chrome trace;
  - Telemetry: structured counters (the reference's printed token counts
    become queryable metrics) and gauges, dumped as one json blob per run;
    its device counters are one int64 tensor a device, added to in place
    and read with one copy when a snapshot is asked for;
  - device_kernels(): the names of the device kernels a call launches,
    from one profiled window (how the card tests check the tile each
    attention kernel took).

The memory build records into the process-wide ``SPANS`` and
``TELEMETRY``, with no synchronise:

  spans     memory.push (one frame's host work; a batch's last push holds
            its flush), memory.flush, and under it memory.stage (the padded
            batch built on the host), memory.h2d (the frames' copies to the
            device; count = bytes), perception.encode and perception.ingest
            (as the host enqueues them, ``memory/pipeline.py``'s step)
  counters  memory.frames_pushed, memory.frames_padded, memory.flushes,
            memory.h2d_bytes on the host; ingest.<name> for each name of
            ``INGEST_COUNTERS`` on the device, from ``ingest_frames``' stats
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

# span records kept: a 51 s window of the memory build at 8 frames a flush
# makes ~17,500 (13 a flush), so the ring holds minutes of mapping
CAPACITY = 65536

# ingest_frames' per-batch counts that the device counters sum
INGEST_COUNTERS = ("points_drawn", "points_gated", "voxels_added",
                   "rows_appended", "rows_replaced", "points_dropped_full")


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


class Span(NamedTuple):
    """One closed scope: ``start`` and ``end`` in ``time.perf_counter``
    seconds, ``parent`` the ``id`` of the scope it opened in (-1 at the
    top), ``flush`` the number of flushes ended before it opened (a
    batch's pushes, its flush and the flush's children share it), and an
    optional ``count`` (memory.h2d: the bytes copied)."""

    name: str
    start: float
    end: float
    parent: int
    flush: int
    count: Optional[int]
    id: int


class Stopwatch:
    """Named wall-clock scopes with aggregation.

        sw = Stopwatch(sync=True)
        with sw("ingest") as h:
            h["result"] = memory.flush()
        print(sw.report())

    ``samples`` holds each name's last ``CAPACITY`` durations, ``records``
    the last ``CAPACITY`` spans (oldest dropped first).  Scopes nest within
    one thread."""

    def __init__(self, sync: bool = False):
        self.samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=CAPACITY))
        self.records: deque = deque(maxlen=CAPACITY)
        self.sync = sync
        self.flush_id = 0
        self._open: List[int] = []
        self._next_id = 0

    @contextlib.contextmanager
    def __call__(self, name: str, count: Optional[int] = None):
        """sync=True: assign the computation's output to
        ``holder["result"]`` inside the block; the scope then ends after
        ``torch.cuda.synchronize`` on the device of its first tensor leaf
        (CUDA launches return before the device finishes).  A result on
        the CPU, or none, ends the scope at once."""
        sid, self._next_id = self._next_id, self._next_id + 1
        parent = self._open[-1] if self._open else -1
        flush = self.flush_id
        self._open.append(sid)
        rf = (torch.profiler.record_function(name)
              if torch.autograd._profiler_enabled() else None)
        holder: Dict[str, object] = {"result": None}
        t0 = time.perf_counter()
        if rf is not None:
            rf.__enter__()
        try:
            yield holder
        finally:
            leaf = _first_leaf(holder.get("result")) if self.sync else None
            if getattr(leaf, "is_cuda", False):
                torch.cuda.synchronize(leaf.device)
            if rf is not None:
                rf.__exit__(None, None, None)
            t1 = time.perf_counter()
            self._open.pop()
            self.samples[name].append(t1 - t0)
            self.records.append(Span(name, t0, t1, parent, flush, count,
                                     sid))

    def next_flush(self) -> None:
        """End the current flush id: later scopes take the next."""
        self.flush_id += 1

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
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto).
    The program's spans in the block appear as ranges of their names."""
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
    """Structured run counters + gauges (json-dumpable).  ``counters`` are
    host numbers; ``count_ingest`` adds an ingest batch's device counts to
    a tensor on their device, which ``snapshot`` reads."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.device: Dict[torch.device, torch.Tensor] = {}

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def count_ingest(self, stats: Dict) -> None:
        """Add one batch's counts (``ingest_frames``' stats: 0-d int64
        tensors named by ``INGEST_COUNTERS``) to the device counters in
        place, with no synchronise.  Stats without them (or none) add
        nothing."""
        if not stats or any(k not in stats for k in INGEST_COUNTERS):
            return
        counts = torch.stack([stats[k] for k in INGEST_COUNTERS])
        acc = self.device.get(counts.device)
        if acc is None:
            self.device[counts.device] = counts
        else:
            acc += counts

    def snapshot(self) -> Dict[str, float]:
        """The host counters and the device counters (``ingest.<name>``),
        the latter read with one copy a device (a synchronise)."""
        out = dict(self.counters)
        for acc in self.device.values():
            for k, v in zip(INGEST_COUNTERS, acc.tolist()):
                out[f"ingest.{k}"] = out.get(f"ingest.{k}", 0) + v
        return out

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
            json.dump({"counters": self.snapshot(),
                       "gauges": self.gauges, **(extra or {})}, f, indent=2)


# the program's process-wide recorder and counter registry (the memory
# build records into them; a benchmark's readers find them by import)
SPANS = Stopwatch()
TELEMETRY = Telemetry()


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
