"""Detector: ms a flush in the program's ``detector.forward`` span (the
frames to the host's patch embeddings; it ends in the blocking copy back,
so it holds the device work), mean over the window's untraced flushes."""

from navbench.metrics._program_spans import flush_ms


def read(out, ctx):
    return flush_ms(out, "detector.forward")
