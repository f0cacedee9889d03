"""Perception: ingest: ms a traced flush the card was idle while the host
was in the program's ``perception.ingest`` span."""

from navbench.metrics._program_spans import idle_ms


def read(out, ctx):
    return idle_ms(out, "ingest")
