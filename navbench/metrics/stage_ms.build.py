"""Agent: ms a flush in the program's ``memory.stage`` span (the padded
batch built on the host from the queued frames), mean over the window's
untraced flushes."""

from navbench.metrics._program_spans import flush_ms


def read(out, ctx):
    return flush_ms(out, "memory.stage")
