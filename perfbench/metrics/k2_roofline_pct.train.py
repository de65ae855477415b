"""K2 (the backward compositing kernel): its least time by the geometry's counts over its device time (%)."""

from perfbench.readers import roofline_pct


def read(t):
    return roofline_pct(t, "train", "k2")
