"""Share of the traced render window in which no kernel, copy or fill ran on the device (%)."""

from perfbench.readers import idle_pct


def read(t):
    return idle_pct(t, "render")
