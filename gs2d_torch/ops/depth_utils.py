"""Depth-map unprojection and pseudo-normals.

Contract of the reference's ``utils/point_utils.py:9-37`` and
``gs2d_tpu/ops/depth_utils.py``: unproject each pixel of a depth map to a
world-space point via the camera's inverse intrinsics (note the W/2 — not
(W−1)/2 — pixel offset here), then take central-difference cross products
as surface normals (zero border).
"""

from __future__ import annotations

import torch

from ..utils import trace


def _intrinsics_rowvec(camera):
    """3×3 pixel→ray matrix pieces, matching point_utils.py:10-17."""
    W, H = camera.width, camera.height
    # a copy from pageable host memory; inv reads its factorisation's info
    trace.count("sync", 2)
    ndc2pix = torch.tensor(
        [
            [W / 2.0, 0.0, 0.0],
            [0.0, H / 2.0, 0.0],
            [0.0, 0.0, 0.0],
            [W / 2.0, H / 2.0, 1.0],
        ],
        dtype=torch.float32, device=camera.device)    # (4,3) row-vector form
    c2w = torch.linalg.inv(camera.world_view.T)        # classic cam→world
    projection = c2w.T @ camera.full_proj              # (4,4) row-vector
    intrins = (projection @ ndc2pix)[:3, :3].T
    return intrins, c2w


def depths_to_points(camera, depthmap: torch.Tensor) -> torch.Tensor:
    """depthmap (H, W) → world points (H, W, 3)."""
    H, W = depthmap.shape[-2:]
    intrins, c2w = _intrinsics_rowvec(camera)
    xs = torch.arange(W, dtype=torch.float32, device=depthmap.device)
    ys = torch.arange(H, dtype=torch.float32, device=depthmap.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # (H, W, 3)
    trace.count("sync")                  # inv reads its factorisation's info
    rays_d = pts @ torch.linalg.inv(intrins).T @ c2w[:3, :3].T
    rays_o = c2w[:3, 3]
    return depthmap.reshape(H, W, 1) * rays_d + rays_o


def depth_to_normal(camera, depth: torch.Tensor) -> torch.Tensor:
    """depth (1, H, W) or (H, W) → normals (H, W, 3), zero border."""
    d = depth.reshape(depth.shape[-2], depth.shape[-1])
    points = depths_to_points(camera, d)
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    # rsqrt(·+eps) keeps the gradient finite where the cross product
    # vanishes (empty / planar-degenerate pixels)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-20)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
