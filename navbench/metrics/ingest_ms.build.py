"""Perception: ingest: ms a flush in the program's ``perception.ingest``
span (the voxel ingest as the host enqueues it), mean over the window's
untraced flushes."""

from navbench.metrics._program_spans import flush_ms


def read(out, ctx):
    return flush_ms(out, "perception.ingest")
