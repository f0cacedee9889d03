"""Agent: ms a flush outside ``Perception.build_step`` (the batch staged
on the host from the queued frames, the memory's bookkeeping), mean over
the window's untraced flushes: the flush's span less the encode and
ingest span inside it."""

from navbench.metrics._build_shapes import window_span_ms


def read(out, ctx):
    flush = window_span_ms(out, "flush")
    inner = window_span_ms(out, "encode_ingest")
    if flush is None or inner is None:
        return None
    return flush - inner
