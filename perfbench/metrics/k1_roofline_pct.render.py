"""K1 (the forward compositing kernel) in rendering: its least time by the geometry's counts over its device time (%)."""

from perfbench.readers import roofline_pct


def read(t):
    return roofline_pct(t, "render", "k1")
