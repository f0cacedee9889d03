"""Perception: ms a flush in ``Perception.build_step`` (ViT-L encode and
the voxel ingest, ending in a synchronise), mean over the window's
untraced flushes."""

from navbench.metrics._build_shapes import window_span_ms


def read(out, ctx):
    return window_span_ms(out, "encode_ingest")
