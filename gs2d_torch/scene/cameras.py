"""Camera model.

Mirrors the reference Camera contract (``scene/cameras.py:17-73`` of the
reference; ``gs2d_tpu/scene/cameras.py``): row-vector ``world_view`` /
``full_proj`` matrices, camera center from the inverse view transform,
znear=0.01 / zfar=100. The matrices are built on the host in NumPy and
held as float32 tensors on the camera's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.transforms import projection_matrix, world_to_view


@dataclasses.dataclass(frozen=True)
class Camera:
    world_view: torch.Tensor  # (4,4) row-vector world→view
    full_proj: torch.Tensor   # (4,4) row-vector world→clip
    campos: torch.Tensor      # (3,) camera center in world space
    fovx: float
    fovy: float
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.world_view.device


@dataclasses.dataclass
class CameraData:
    """A training view: the camera and its image (the counterpart of
    ``gs2d_tpu/scene/cameras.py::CameraData``). The training loop uploads
    ``image`` to its device once and keeps it there."""
    camera: Camera
    image: Optional[torch.Tensor] = None        # (3, H, W) float32 in [0, 1]
    alpha_mask: Optional[torch.Tensor] = None   # (1, H, W) or None
    image_name: str = ""
    uid: int = 0
    # the raw COLMAP-style R (cam→world) and T (world→cam) it was built from
    R: Optional[np.ndarray] = None
    T: Optional[np.ndarray] = None


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int,
                znear: float = 0.01, zfar: float = 100.0,
                translate=np.array([0.0, 0.0, 0.0]), scale: float = 1.0,
                device="cuda") -> Camera:
    """Build a Camera from COLMAP-style R (cam→world rotation) and t
    (world→cam translation), as the reference does in
    ``scene/cameras.py:57-60``."""
    w2v = world_to_view(R, t, translate, scale)       # column-vector form
    proj = projection_matrix(znear, zfar, fovx, fovy)  # column-vector form

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    return Camera(
        world_view=dev(w2v.T),                         # row-vector form
        full_proj=dev((proj @ w2v).T),                 # row-vector form
        campos=dev(np.linalg.inv(w2v)[:3, 3]),
        width=int(width), height=int(height), fovx=float(fovx),
        fovy=float(fovy), znear=znear, zfar=zfar,
    )
