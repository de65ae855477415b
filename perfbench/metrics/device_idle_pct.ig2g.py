"""Share of the traced IG2G window (two whole cycles of an edit and its training steps) in which no kernel, copy or fill ran on the device (%)."""

from perfbench.readers import idle_pct


def read(t):
    return idle_pct(t, "ig2g")
