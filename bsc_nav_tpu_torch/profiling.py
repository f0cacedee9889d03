"""Which device kernels a call launches, by torch.profiler: how the card
tests check the tile each attention kernel took, and how ``chip_smoke.py``
lists the kernels SDPA runs (``chip_smoke.py`` checks tiles by the
launchers' own counts: late in its long run a profiled window has come
back empty)."""

from __future__ import annotations

import torch


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
