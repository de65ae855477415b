"""Kernels launched in the traced IG2G window (two whole cycles of an edit and its training steps) per iteration, the edit's launches shared over its cycle."""

from perfbench.readers import launches_per_unit


def read(t):
    return launches_per_unit(t, "ig2g")
