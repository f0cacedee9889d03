"""The program's own spans (``bsc_nav_tpu_torch.utils.profiling.SPANS``,
read in the run's process after the window) and their place on the
device trace's clock.

Host-time readers take the flushes before the traced part, as
``_build_shapes.window_span_ms`` does.  Idle readers move the spans onto
the profiler's clock by the median offset between navbench's own ``flush``
spans there (``out.trace.spans``) and on ``perf_counter``
(``out.spans``), and count each idle instant of the traced window once,
for the innermost program span open on the host then.  A program that
keeps no such spans gives None: the readers then report nothing."""

from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

from navbench import arith

# innermost span name (prefix) -> the layer its idle time is put against
IDLE_LAYERS = (("perception.encode", "encode"), ("perception.ingest", "ingest"),
               ("memory.", "agent"))


def records() -> Optional[list]:
    """The program's span records, or None where the program keeps none."""
    from bsc_nav_tpu_torch.utils import profiling
    recs = getattr(getattr(profiling, "SPANS", None), "records", None)
    return list(recs) if recs else None


def _untraced_flushes(out, recs) -> Set[int]:
    """Flush ids of the program's flushes that start in the window before
    its traced part."""
    return {r.flush for r in recs if r.name == "memory.flush"
            and out.window_t0 <= r.start < out.traced_t0}


def window_span(out, name: str) -> Optional[Tuple[float, int, int]]:
    """(seconds, summed count, flushes) of the program's spans ``name``
    over the window's untraced flushes, or None where there are none."""
    recs = records()
    if not recs:
        return None
    ids = _untraced_flushes(out, recs)
    mine = [r for r in recs if r.name == name and r.flush in ids]
    if not mine:
        return None
    return (sum(r.end - r.start for r in mine),
            sum(r.count or 0 for r in mine), len(ids))


def flush_ms(out, name: str) -> Optional[float]:
    """Mean ms a flush in the program's spans ``name``, untraced flushes."""
    got = window_span(out, name)
    return None if got is None else 1e3 * got[0] / got[2]


def clock_offset(out) -> Optional[float]:
    """Seconds that take a ``perf_counter`` time onto the profiler's clock:
    the median over the traced flushes of navbench's ``flush`` span's start
    there less its start on ``perf_counter``."""
    if out.trace is None:
        return None
    host = sorted(s for s, _ in out.spans.items.get("flush", [])
                  if s >= out.traced_t0)
    prof = sorted(s for n, s, _ in out.trace.spans if n == "flush")
    if not host or len(host) != len(prof):
        return None
    return statistics.median(p - h for p, h in zip(prof, host))


def mapped(out) -> Optional[List[tuple]]:
    """The program's spans that overlap the traced window, on the
    profiler's clock: [(start, end, name, id)]."""
    recs = records()
    off = clock_offset(out)
    if not recs or off is None:
        return None
    lo, hi = out.trace.lo, out.trace.hi
    return [(r.start + off, r.end + off, r.name, r.id) for r in recs
            if r.end + off > lo and r.start + off < hi]


def _innermost(spans: List[tuple]) -> List[Tuple[float, float, str]]:
    """Nested spans [(start, end, name, id)] -> [(t0, t1, name of the
    innermost span open)] in time order; time no span covers is left
    out.  A span opened earlier has the lower id, so ties keep nesting."""
    events = sorted([(s, 1, i, n) for s, _, n, i in spans]
                    + [(e, 0, i, n) for _, e, n, i in spans])
    segs, open_, t = [], [], None
    for time, is_start, i, n in events:
        if open_ and time > t:
            segs.append((t, time, open_[-1][1]))
        t = time
        if is_start:
            open_.append((i, n))
        else:
            open_.remove((i, n))
    return segs


def idle_by_layer(out) -> Optional[Dict[str, float]]:
    """Seconds of the traced window in which the device was idle, by the
    layer (``IDLE_LAYERS``) of the innermost program span open then."""
    spans = mapped(out)
    if not spans:
        return None
    segs = _innermost(spans)
    gaps = sorted(arith.idle_gaps([(s, e) for _, s, e in out.trace.kernels],
                                  out.trace.lo, out.trace.hi))
    by: Dict[str, float] = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            t0, t1, name = segs[k]
            layer = next((lay for pre, lay in IDLE_LAYERS
                          if name.startswith(pre)), None)
            if layer is not None:
                by[layer] += min(g1, t1) - max(g0, t0)
            k += 1
    return dict(by)


def idle_ms(out, layer: str) -> Optional[float]:
    """ms a traced flush the device was idle under ``layer``'s spans."""
    if out.trace is None or not out.traced_items:
        return None
    by = idle_by_layer(out)
    return None if by is None else 1e3 * by.get(layer, 0.0) / out.traced_items
