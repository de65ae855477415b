"""Camera / projective geometry in the reference's conventions.

NumPy copy of ``gs2d_tpu/ops/transforms.py`` (the port imports nothing
from the JAX package). Contracts mirrored from the reference 2DGS code
(``utils/graphics_utils.py:31-77`` and ``scene/cameras.py:57-60``):

- ``world_to_view`` and ``projection_matrix`` return the CLASSIC
  column-vector matrices (as the reference's getWorld2View2 /
  getProjectionMatrix do); scene/cameras.py transposes them into the
  row-vector ``p_h @ M`` forms the pipeline consumes — do NOT pass these
  untransposed into preprocess().
- Projection: OpenGL-style frustum with z_sign=+1 and the reference's
  depth remap rows, so clip-space w equals camera-space z.
- ndc→pixel: x_pix = x_ndc * W/2 + (W-1)/2 (half-pixel-centered),
  written out on the device by ``ops/rasterize/preprocess.py::world_to_pix``.

All functions are host-side NumPy; cameras move the results to the device.
"""

from __future__ import annotations

import math

import numpy as np


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]), scale: float = 1.0) -> np.ndarray:
    """4x4 world→view (classic column-vector form), with an optional rigid
    recentering applied to the camera center (reference getWorld2View2)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """4x4 perspective projection (column-vector form, reference
    getProjectionMatrix): clip w = +z_view, depth row maps z to
    [0, zfar] range via zfar/(zfar-znear)·z − zfar·znear/(zfar-znear)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))
