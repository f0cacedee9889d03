"""What every cell's driver shares: host spans, the traced window, the
memory peak and the checks' table.

Spans are taken in the benchmark's own wrappers around the program's
calls (host clock; a span that ends in a synchronise holds its device
work).  A traced window runs ``torch.profiler`` over CPU and CUDA
activity; each span is also a ``record_function`` range there, so that a
device idle gap can be labelled by the span that was open on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from navbench import arith


class Spans:
    """Named host spans: (start, end) perf_counter seconds each.  While a
    window is traced each span is also a ``record_function`` range."""

    def __init__(self):
        self.items: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(f"navbench:{name}")
              if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.items[name].append((t0, time.perf_counter()))

    def wrap(self, name: str, fn: Callable) -> Callable:
        """fn inside a span that ends once the device has finished what fn
        queued."""
        def wrapped(*a, **k):
            with self(name):
                out = fn(*a, **k)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            return out
        return wrapped

    def durations(self, name: str, lo: float = float("-inf"),
                  hi: float = float("inf")) -> List[float]:
        """Seconds of the spans ``name`` that start in [lo, hi)."""
        return [e - s for s, e in self.items.get(name, []) if lo <= s < hi]


@dataclasses.dataclass
class Trace:
    """A traced window: device operations [(name, start_s, end_s)] on the
    profiler's clock, host spans [(name, start_s, end_s)] on the same
    clock, and the window's bounds there."""

    kernels: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    lo: float
    hi: float

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return arith.busy_seconds([(s, e) for _, s, e in self.kernels])

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n))

    def breakdown(self, n: int = 10) -> Dict:
        """The device operations that took most time (summed by name) and
        the longest idle gaps, each named by the innermost host span open
        when it began."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = arith.idle_gaps([(s, e) for _, s, e in self.kernels],
                               self.lo, self.hi)[:n]

        def label(t):
            open_ = [(s, nm) for nm, s, e in self.spans if s <= t < e]
            return max(open_)[1] if open_ else "host: outside any span"

        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[label(s), e - s] for s, e in gaps]}


class Tracer:
    """``with tracer:`` profiles the block; ``result()`` reads it."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.spans.traced = True
        self._window = torch.profiler.record_function("navbench:window")
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.spans.traced = False
        self.prof.__exit__(*exc)
        return False

    def result(self) -> Trace:
        events = self.prof.profiler.kineto_results.events()
        kernels, spans, lo, hi = [], [], None, None
        for e in events:
            name = e.name()
            s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # a record_function range is mirrored on the device's
                # timeline as an annotation: no device work
                if not (e.is_user_annotation() or name.startswith("navbench:")):
                    kernels.append((name, s, s + d))
            elif name == "navbench:window":
                lo, hi = s, s + d
            elif name.startswith("navbench:"):
                spans.append((name[len("navbench:"):], s, s + d))
        if lo is None:
            raise RuntimeError("the traced window's range is missing from "
                               "the profile")
        kernels = [(n, max(s, lo), min(e, hi)) for n, s, e in kernels
                   if e > lo and s < hi]
        return Trace(kernels, spans, lo, hi)


def device_info(count: int) -> Dict:
    """The result line's ``device``: platform, card, count and peak."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


@dataclasses.dataclass
class Check:
    """One number the correctness check compares, with its limit: the
    run is correct when every value lies at or under its limit."""

    name: str
    value: float
    limit: float
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics of its window,
    the material of the per-layer metrics, and the checks."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    device: Dict
    spans: Spans
    trace: Optional[Trace] = None
    traced_items: int = 0
    window_t0: float = 0.0                 # perf_counter at the window's start
    traced_t0: float = float("inf")        # ... and at the traced part's
    info: Dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)
