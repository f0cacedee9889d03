"""Long-term memory: ms a flush in the program's ``detector.post`` (heat
maps and boxes on the host) and ``longterm.feed`` (the boxes located and
integrated) spans, mean over the window's untraced flushes."""

from navbench.metrics._program_spans import flush_ms


def read(out, ctx):
    post = flush_ms(out, "detector.post")
    feed = flush_ms(out, "longterm.feed")
    if post is None or feed is None:
        return None
    return post + feed
