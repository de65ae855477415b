"""Kernels launched in the traced render window per view."""

from perfbench.readers import launches_per_unit


def read(t):
    return launches_per_unit(t, "render")
