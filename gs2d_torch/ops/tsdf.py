"""TSDF fusion on the volume's device.

Counterpart of ``gs2d_tpu/ops/tsdf.py`` (which replaces Open3D's
ScalableTSDFVolume of the reference's bounded meshing path,
``utils/mesh_utils.py:154-195``), in plain torch: a dense voxel grid is
integrated against each view's depth and colour maps with projective
signed distance, truncation and running-average weights, in X-slabs so
the working set stays a few hundred MB beside the volume. The operations
and their float32 order are the JAX package's.

Two focal conventions, both centred at (W-1)/2: the bounded path
(``integrate``, like Open3D) takes fx = W/(2·tan) and samples the NEAREST
pixel; the unbounded path (``fuse_sdf_points_views``) takes (W-1)/(2·tan)
from its caller and samples bilinearly with border clamping.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TSDFVolume:
    tsdf: torch.Tensor     # (X, Y, Z) f32 in [-1, 1]
    weight: torch.Tensor   # (X, Y, Z) f32
    color: torch.Tensor    # (X, Y, Z, 3) f32
    origin: torch.Tensor   # (3,) f32 world position of voxel (0,0,0)
    voxel_size: float


def make_volume(center: np.ndarray, radius: float, voxel_size: float,
                max_dim: int = 512, device="cuda") -> TSDFVolume:
    dim = int(np.ceil(2 * radius / voxel_size))
    if dim > max_dim:
        # capping must COARSEN the voxels, never shrink the covered extent
        # (a fixed-voxel cap would leave the grid in one corner of the
        # scene and nothing would ever integrate)
        dim = max_dim
        voxel_size = 2 * radius / max_dim
    origin = np.asarray(center, np.float32) - radius
    shape = (dim, dim, dim)
    return TSDFVolume(
        tsdf=torch.ones(shape, dtype=torch.float32, device=device),
        weight=torch.zeros(shape, dtype=torch.float32, device=device),
        color=torch.zeros(shape + (3,), dtype=torch.float32, device=device),
        origin=torch.as_tensor(origin, device=device),
        voxel_size=float(voxel_size),
    )


def integrate(vol: TSDFVolume, depth: torch.Tensor, color: torch.Tensor,
              world_view: torch.Tensor, fx: float, fy: float,
              width: int, height: int, sdf_trunc: float,
              depth_trunc: float, slab_voxels: int = 1 << 22) -> TSDFVolume:
    """Integrate one view into ``vol`` in place (and return it). depth
    (H, W); color (3, H, W); world_view the row-vector world→view
    transform; (fx, fy) focal lengths in pixels. Every tensor lies on the
    volume's device."""
    X, Y, Z = vol.tsdf.shape
    dev = vol.tsdf.device
    bx = max(1, min(X, slab_voxels // max(Y * Z, 1)))
    # depth and colour packed as one (H·W, 4) row table: one gather a tap
    table = torch.cat([depth[..., None], color.permute(1, 2, 0)],
                      -1).reshape(-1, 4)
    jj, kk = torch.meshgrid(torch.arange(Y, device=dev),
                            torch.arange(Z, device=dev), indexing="ij")
    jk = torch.stack([jj, kk], -1).reshape(-1, 2).to(torch.float32)
    rot, shift = world_view[:3, :3], world_view[3, :3]
    f32 = torch.float32
    for x0 in range(0, X, bx):
        n = min(bx, X - x0)
        ii = (x0 + torch.arange(n, dtype=f32, device=dev))[:, None, None]
        pts = torch.cat([ii.expand(n, Y * Z, 1),
                         jk[None].expand(n, Y * Z, 2)], -1
                        ).reshape(-1, 3) * vol.voxel_size + vol.origin
        p_view = pts @ rot + shift
        z = p_view[:, 2]
        zc = torch.clamp(z, min=1e-9)
        # pinhole projection with half-pixel center (ndc2pix (W-1)/2)
        u = p_view[:, 0] / zc * fx + (width - 1) / 2.0
        v = p_view[:, 1] / zc * fy + (height - 1) / 2.0
        inb = ((z > 1e-4) & (u >= 0) & (u <= width - 1)
               & (v >= 0) & (v <= height - 1))
        # NEAREST-pixel sampling, as Open3D's integrate does: bilinear
        # depth taps straddling a masked silhouette blend zeros with real
        # depth into bogus fractional depths that still pass validity
        ui = torch.clamp(torch.round(u), 0, width - 1).to(torch.int64)
        vi = torch.clamp(torch.round(v), 0, height - 1).to(torch.int64)
        samp = table[vi * width + ui]
        d_samp = samp[:, 0]
        c_samp = samp[:, 1:4]
        valid_d = (d_samp > 1e-6) & (d_samp < depth_trunc)
        sdf = d_samp - z
        upd = inb & valid_d & (sdf > -sdf_trunc)
        d = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)

        w_old = vol.weight[x0:x0 + n].reshape(-1)
        t_old = vol.tsdf[x0:x0 + n].reshape(-1)
        c_old = vol.color[x0:x0 + n].reshape(-1, 3)
        w_new = w_old + upd.to(f32)
        denom = torch.clamp(w_new, min=1.0)
        t_new = torch.where(upd, (t_old * w_old + d) / denom, t_old)
        c_new = torch.where(upd[:, None],
                            (c_old * w_old[:, None] + c_samp)
                            / denom[:, None], c_old)
        vol.tsdf[x0:x0 + n] = t_new.reshape(n, Y, Z)
        vol.weight[x0:x0 + n] = w_new.reshape(n, Y, Z)
        vol.color[x0:x0 + n] = c_new.reshape(n, Y, Z, 3)
    return vol


def fuse_sdf_points_views(pts: torch.Tensor, trunc: torch.Tensor,
                          depths: torch.Tensor, colors: torch.Tensor,
                          alphas: torch.Tensor, world_views: torch.Tensor,
                          fxs: torch.Tensor, fys: torch.Tensor,
                          width: int, height: int):
    """Free-point projective SDF fusion over all views of one resolution
    (the reference's compute_sdf_perframe, mesh_utils.py:211-222):
    bilinear border-clamped sampling, mask = in-frustum & z > 0, plus the
    JAX package's alpha > 0.5 gate (which keeps empty background, depth 0,
    from carving a shell around the cameras). depths (V,H,W), colors
    (V,3,H,W), alphas (V,H,W), world_views (V,4,4), fxs/fys (V,) →
    (sdf, w, col) running-mean accumulators for the points."""
    V = depths.shape[0]
    tables = torch.cat([depths[..., None], alphas[..., None],
                        colors.permute(0, 2, 3, 1)], -1).reshape(V, -1, 5)
    N = pts.shape[0]
    sdf_a = torch.ones(N, dtype=torch.float32, device=pts.device)
    w_a = torch.zeros(N, dtype=torch.float32, device=pts.device)
    col_a = torch.zeros((N, 3), dtype=torch.float32, device=pts.device)
    for table, wv, fx, fy in zip(tables, world_views, fxs, fys):
        pv = pts @ wv[:3, :3] + wv[3, :3]
        z = pv[:, 2]
        zc = torch.clamp(z, min=1e-9)
        u = pv[:, 0] / zc * fx + (width - 1) / 2.0
        v = pv[:, 1] / zc * fy + (height - 1) / 2.0
        inb = ((z > 0) & (u >= 0) & (u <= width - 1)
               & (v >= 0) & (v <= height - 1))
        uc = torch.clamp(u, 0.0, width - 1.0)
        vc = torch.clamp(v, 0.0, height - 1.0)
        x0i = torch.clamp(torch.floor(uc), 0, width - 2).to(torch.int64)
        y0i = torch.clamp(torch.floor(vc), 0, height - 2).to(torch.int64)
        fxw = torch.clamp(uc - x0i, 0.0, 1.0)[:, None]
        fyw = torch.clamp(vc - y0i, 0.0, 1.0)[:, None]
        base = y0i * width + x0i
        samp = (table[base] * (1 - fxw) * (1 - fyw)
                + table[base + 1] * fxw * (1 - fyw)
                + table[base + width] * (1 - fxw) * fyw
                + table[base + width + 1] * fxw * fyw)
        d_s, a_s, c_s = samp[:, 0], samp[:, 1], samp[:, 2:5]
        sdf = d_s - z
        ok = inb & (a_s > 0.5) & (sdf > -trunc)
        d = torch.clamp(sdf / trunc, -1.0, 1.0)
        w_new = w_a + ok.to(torch.float32)
        denom = torch.clamp(w_new, min=1.0)
        sdf_a = torch.where(ok, (sdf_a * w_a + d) / denom, sdf_a)
        col_a = torch.where(ok[:, None],
                            (col_a * w_a[:, None] + c_s) / denom[:, None],
                            col_a)
        w_a = w_new
    return sdf_a, w_a, col_a
