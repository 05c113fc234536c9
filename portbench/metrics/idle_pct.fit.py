"""Share of the traced window in which no kernel or copy ran on the card,
in percent (device trace)."""

from portbench.kernels import idle_pct


def read(ctx):
    return idle_pct(ctx)
