"""Perception: encode: ms a flush in the program's ``perception.encode``
span (preprocess and ViT-L as the host enqueues them), mean over the
window's untraced flushes."""

from navbench.metrics._program_spans import flush_ms


def read(out, ctx):
    return flush_ms(out, "perception.encode")
