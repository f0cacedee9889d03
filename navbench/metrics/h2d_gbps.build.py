"""Agent: GB/s of the frames' copies to the device, the bytes the
program's ``memory.h2d`` spans carry over their summed host time (each
copy blocks), over the window's untraced flushes."""

from navbench.metrics._program_spans import window_span


def read(out, ctx):
    got = window_span(out, "memory.h2d")
    if got is None or got[0] <= 0 or not got[1]:
        return None
    return got[1] / got[0] / 1e9
