"""Kernels launched in the traced training window per iteration."""

from perfbench.readers import launches_per_unit


def read(t):
    return launches_per_unit(t, "train")
