"""Agent: ms a traced flush the card was idle while the innermost program
span open on the host was ``memory.push``, ``memory.flush`` or one of its
staging spans (in no ``perception.*`` span)."""

from navbench.metrics._program_spans import idle_ms


def read(out, ctx):
    return idle_ms(out, "agent")
