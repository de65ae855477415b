"""Shared helpers for the port's parity tests (no tests of its own).

Inputs are made with NumPy from a seed (tests/utils.py) and handed to the
JAX package and to gs2d_torch as the same arrays; the port runs on the
CPU, where every kernel wrapper takes its plain PyTorch version.
"""

import math

import numpy as np
import pytest
import torch

from gs2d_torch.scene.cameras import make_camera


def port_camera(width=128, height=64, fov=60.0, dist=4.0):
    """gs2d_torch twin of tests/utils.py lookat_camera, on the CPU."""
    fovx = math.radians(fov)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    return make_camera(np.eye(3), np.array([0.0, 0.0, dist]), fovx, fovy,
                       width, height, device="cpu")


def to_t(x):
    """NumPy or JAX array → CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(x))


def tile_lists(gid, tile_start, tile_count):
    """Per-tile slot lists as Python lists of Gaussian ids."""
    gid, start, count = (np.asarray(x) for x in (gid, tile_start, tile_count))
    return [gid[s:s + c].tolist() for s, c in zip(start, count)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch while a module that imports this
    fixture runs: the test run puts several workers on the machine's
    cores, and the OpenMP threads of several torch workers, each sized to
    every core, thrash one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
