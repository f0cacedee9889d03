"""Detector: ms a traced flush the card was idle while the innermost
program span open on the host was a ``detector.*`` span."""

from navbench.metrics._cliph_idle import idle_ms


def read(out, ctx):
    return idle_ms(out, "detector")
