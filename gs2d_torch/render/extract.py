"""Mesh extraction: render all views, TSDF-fuse, marching tetrahedra.

Counterpart of ``gs2d_tpu/render/extract.py`` (the reference's
GaussianExtractor, ``utils/mesh_utils.py:73-312``): per-view RGB +
surface-depth rendering through ``render()`` (K1), the camera-orbit
bounding sphere, bounded TSDF fusion (``ops/tsdf.py`` + ``ops/marching.py``
on the device), unbounded extraction with the MipNeRF-360 contraction and
adaptive truncation, block by block, image export through the port's PNG
encoder, and largest-cluster post-processing. The maps stay on the
device; the meshes come back as NumPy arrays. The JAX extractor's
pair-capacity overflow retry has no counterpart: tensors resize.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..models.gaussians import GaussianState
from ..ops.marching import largest_clusters, marching_tets, unique_rows
from ..ops.transforms import fov2focal
from ..ops.tsdf import (TSDFVolume, fuse_sdf_points_views, integrate,
                        make_volume)
from ..scene.cameras import CameraData
from ..scene.images import encode_png
from ..scene.ply import write_mesh_ply
from ..utils.render_paths import focus_point_fn
from .renderer import render


def _norm3(y: torch.Tensor) -> torch.Tensor:
    """``np.linalg.norm(y, axis=-1)`` of float32 rows, in NumPy's order of
    operations for three elements: (x0² + x1²) + x2²."""
    sq = y * y
    return torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])


def _uncontract(y: torch.Tensor) -> torch.Tensor:
    n = _norm3(y)[..., None]
    return torch.where(n <= 1, y,
                       1 / (2 - torch.clamp(n, min=1e-9)) * y / n)


class GaussianExtractor:
    def __init__(self, state: GaussianState, *, max_sh_degree: int = 3,
                 depth_ratio: float = 0.0, bg_color=(0.0, 0.0, 0.0),
                 device="cuda"):
        self.state = state
        self.max_sh_degree = max_sh_degree
        self.depth_ratio = depth_ratio
        self.device = torch.device(device)
        self.bg = torch.tensor(bg_color, dtype=torch.float32,
                               device=self.device)
        self.clean()

    def clean(self):
        self.rgbmaps: List[torch.Tensor] = []
        self.depthmaps: List[torch.Tensor] = []
        self.alphamaps: List[torch.Tensor] = []
        self.normalmaps: List[torch.Tensor] = []
        self.viewpoints: List[CameraData] = []

    @torch.no_grad()
    def reconstruction(self, viewpoints: List[CameraData]):
        """Render every view and keep rgb / surface depth / alpha / normal
        on the device (reference :104-137)."""
        self.clean()
        self.viewpoints = list(viewpoints)
        for cam_data in viewpoints:
            pkg = render(cam_data.camera, self.state, self.bg,
                         max_sh_degree=self.max_sh_degree,
                         depth_ratio=self.depth_ratio, device=self.device)
            self.rgbmaps.append(torch.clamp(pkg["render"], 0, 1))
            self.depthmaps.append(pkg["surf_depth"])
            self.alphamaps.append(pkg["rend_alpha"])
            self.normalmaps.append(pkg["rend_normal"])
        # the bounding sphere of THESE cameras (reference :137)
        self.estimate_bounding_sphere()

    def estimate_bounding_sphere(self):
        """Focus point + min camera distance (reference :139-151)."""
        c2ws = np.array([np.linalg.inv(cd.camera.world_view.T.cpu().numpy())
                         for cd in self.viewpoints])
        poses = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
        center = focus_point_fn(poses)
        self.radius = float(np.linalg.norm(c2ws[:, :3, 3] - center,
                                           axis=-1).min())
        self.center = center
        return self.center, self.radius

    @torch.no_grad()
    def extract_mesh_bounded(self, voxel_size=0.004, sdf_trunc=0.02,
                             depth_trunc=3.0, max_dim=640,
                             mask_background=True):
        """Bounded TSDF fusion (reference :154-195) → NumPy (verts,
        faces, colors). The dense grid is capped at max_dim³ (640³ × 5
        float32 channels ≈ 5.2 GB); when the cap coarsens the requested
        voxel, that is printed: scores at another resolution are not
        comparable."""
        if not hasattr(self, "radius"):
            self.estimate_bounding_sphere()
        vol = make_volume(self.center, depth_trunc / 2.0 + self.radius,
                          voxel_size, max_dim=max_dim, device=self.device)
        if vol.voxel_size > float(voxel_size) * 1.01:
            print(f"[extract_mesh_bounded] WARNING: requested voxel "
                  f"{voxel_size} needs dim > {max_dim}; coarsened to "
                  f"{vol.voxel_size:.5f} — scores are NOT protocol-"
                  f"comparable (raise max_dim if memory allows)")
        # a coarsened grid keeps the truncation band a few voxels wide, or
        # marching finds no crossings
        sdf_trunc = max(float(sdf_trunc), 2.5 * vol.voxel_size)
        for i, cd in enumerate(self.viewpoints):
            cam = cd.camera
            depth = self.depthmaps[i].reshape(cam.height, cam.width)
            # the reference masks depth ONLY with the dataset's GT alpha
            # mask (mesh_utils.py:181-182); empty-background pixels carry
            # depth ≈ 0 and integrate()'s validity gate drops them
            if mask_background and cd.alpha_mask is not None:
                m = cd.alpha_mask.to(self.device).reshape(cam.height,
                                                          cam.width)
                depth = torch.where(m > 0.5, depth, 0.0)
            integrate(vol, depth, self.rgbmaps[i], cam.world_view,
                      fov2focal(cam.fovx, cam.width),
                      fov2focal(cam.fovy, cam.height),
                      cam.width, cam.height, float(sdf_trunc),
                      float(depth_trunc))
        self.volume = vol
        verts, faces = marching_tets(vol.tsdf, vol.origin, vol.voxel_size,
                                     mask=vol.weight > 0)
        colors = self._sample_colors(vol, verts)
        return (verts.cpu().numpy(), faces.cpu().numpy(),
                colors.cpu().numpy())

    @torch.no_grad()
    def extract_mesh_unbounded(self, resolution=512, block_size=256,
                               max_range=32.0):
        """Unbounded meshing with the MipNeRF-360 contraction (reference
        :198-293) → NumPy (verts, faces, colors): a contracted-space SDF
        grid by projective fusion over all views with adaptive truncation,
        marching tets in contracted space, vertices un-contracted.

        Block by block, like the reference's
        marching_cubes_with_contraction (utils/mcube_utils.py:17-95):
        ``block_size``³ chunks with one-point overlap, so peak memory is
        bounded by the block; block meshes are merged by lattice-quantized
        vertex welding, so the result is a monolithic extraction's."""
        if not hasattr(self, "radius"):
            self.estimate_bounding_sphere()
        dev = self.device
        scale = 1.0 / self.radius
        N = resolution
        # grid bound from the splats, like the reference (:274-276):
        # R = min(q95(|contract(normalize(xyz))|) + 0.01, 1.9)
        state = getattr(self, "state", None)
        if state is not None:
            means = state.params.xyz.detach().cpu().numpy()
            ynorm = np.linalg.norm((means - self.center) / self.radius,
                                   axis=-1)
            cmag = np.where(ynorm < 1, ynorm,
                            2 - 1 / np.maximum(ynorm, 1e-9))
        else:
            cmag = np.zeros((0,))
        R = float(min(np.quantile(cmag, 0.95) + 0.01, 1.9)) if len(cmag) \
            else 1.9
        lin = np.linspace(-R, R, N).astype(np.float32)
        voxel = float(lin[1] - lin[0]) if N > 1 else 1.0
        origin_c = np.array([lin[0]] * 3, np.float32)
        lin_d = torch.as_tensor(lin, device=dev)
        center_d = torch.as_tensor(self.center, device=dev)

        # views grouped by resolution so per-view maps stack
        groups = {}
        for i, cd in enumerate(self.viewpoints):
            groups.setdefault((cd.camera.width, cd.camera.height),
                              []).append(i)
        stacked = []
        for (w, h), idxs in groups.items():
            cams = [self.viewpoints[i].camera for i in idxs]
            stacked.append((
                w, h,
                torch.stack([self.depthmaps[i].reshape(h, w) for i in idxs]),
                torch.stack([self.rgbmaps[i].reshape(3, h, w)
                             for i in idxs]),
                torch.stack([self.alphamaps[i].reshape(h, w) for i in idxs]),
                torch.stack([c.world_view for c in cams]),
                # (W-1)/(2·tan): the reference samples with grid_sample
                # align_corners=True (mesh_utils.py:217-219)
                torch.tensor([fov2focal(c.fovx, w - 1) for c in cams],
                             dtype=torch.float32, device=dev),
                torch.tensor([fov2focal(c.fovy, h - 1) for c in cams],
                             dtype=torch.float32, device=dev)))

        def block_sdf(i0s, i1s):
            """Fused (sdf, w, col) for grid points [i0, i1) per axis."""
            axes = [lin_d[i0:i1] for i0, i1 in zip(i0s, i1s)]
            grid = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                               -1).reshape(-1, 3)
            r = _norm3(grid)
            # adaptive truncation ∝ 1/(2-|y|) (reference :229-232) in WORLD
            # units, independent of R: the reference's voxel_size comes
            # from the full ±2 span (:269)
            trunc = 5 * (2 / N) / scale * torch.where(
                r > 1, 1.0 / (2 - torch.clamp(r, max=1.9)), 1.0)
            world = ((_uncontract(grid) / scale).double()
                     + center_d).to(torch.float32)
            n = grid.shape[0]
            sdf_n = torch.zeros(n, dtype=torch.float32, device=dev)
            w_n = torch.zeros(n, dtype=torch.float32, device=dev)
            col_n = torch.zeros((n, 3), dtype=torch.float32, device=dev)
            for (w, h, dep, rgb, al, wv, fxs, fys) in stacked:
                s_g, w_g, c_g = fuse_sdf_points_views(
                    world, trunc, dep, rgb, al, wv, fxs, fys, w, h)
                sdf_n += s_g * w_g
                w_n += w_g
                col_n += c_g * w_g[:, None]
            # reference init: tsdfs = 1 with weights = 1, a unit prior in
            # the running mean; colours share the weight with a zero prior
            denom = 1.0 + w_n
            sdf_n = (1.0 + sdf_n) / denom
            col_n = col_n / denom[:, None]
            shape = tuple(i1 - i0 for i0, i1 in zip(i0s, i1s))
            return (sdf_n.reshape(shape), w_n.reshape(shape),
                    col_n.reshape(shape + (3,)))

        # block starts with one-point overlap: cubes [s, e-1) per block
        starts = list(range(0, max(N - 1, 1), max(block_size - 1, 1)))
        all_vc, all_faces, all_cols = [], [], []
        for sx in starts:
            for sy in starts:
                for sz in starts:
                    i0s = (sx, sy, sz)
                    i1s = tuple(min(s + block_size, N) for s in i0s)
                    sdf_b, w_b, col_b = block_sdf(i0s, i1s)
                    if not (bool((sdf_b < 0).any())
                            and bool((sdf_b > 0).any())):
                        continue
                    org = origin_c + np.array(i0s) * voxel
                    vc, fc = marching_tets(sdf_b.double(), origin=org,
                                           voxel_size=voxel, mask=w_b > 0)
                    if fc.shape[0] == 0:
                        continue
                    hi = torch.tensor(sdf_b.shape, device=dev) - 1
                    gi = torch.minimum(torch.clamp(torch.round(
                        (vc.double() - torch.as_tensor(org, device=dev))
                        / voxel).to(torch.int64), min=0), hi)
                    all_cols.append(col_b[gi[:, 0], gi[:, 1], gi[:, 2]])
                    all_vc.append(vc)
                    all_faces.append(fc)
        if not all_vc:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int64),
                    np.zeros((0, 3), np.float32))

        # weld across block boundaries on the 1/1024-voxel lattice (the
        # grid marching_tets welds on per block); a welded vertex keeps
        # its first occurrence, as np.unique(return_index=True) does
        offs = np.cumsum([0] + [v.shape[0] for v in all_vc[:-1]])
        verts_c = torch.cat(all_vc)
        faces = torch.cat([f + int(o) for f, o in zip(all_faces, offs)])
        cols = torch.cat(all_cols)
        keys = torch.round((verts_c - torch.as_tensor(origin_c, device=dev))
                           / voxel * 1024.0).to(torch.int64)
        n, inv, _ = unique_rows(keys)
        first = torch.full((n,), verts_c.shape[0], dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, inv, torch.arange(verts_c.shape[0], device=dev), "amin")
        verts_c, cols, faces = verts_c[first], cols[first], inv[faces]
        ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
              & (faces[:, 0] != faces[:, 2]))
        faces = faces[ok]

        # clip un-contracted world vertices like the reference
        # (mcube_utils.py:91-93): a crossing at contracted radius 2-ε
        # un-contracts through 1/(2-|y|) to arbitrarily far points
        verts = torch.clamp((_uncontract(verts_c) / scale).double()
                            + center_d, -max_range, max_range)
        return (verts.to(torch.float32).cpu().numpy(), faces.cpu().numpy(),
                cols.cpu().numpy())

    def _sample_colors(self, vol: TSDFVolume, verts: torch.Tensor):
        if verts.shape[0] == 0:
            return torch.zeros((0, 3), dtype=torch.float32)
        g = (verts - vol.origin) / vol.voxel_size
        hi = torch.tensor(vol.tsdf.shape, device=verts.device) - 1
        gi = torch.minimum(torch.clamp(g.to(torch.int64), min=0), hi)
        return vol.color[gi[:, 0], gi[:, 1], gi[:, 2]]

    def export_image(self, path: str):
        """renders/, gt/, vis/ layout (reference :296-312), through the
        port's PNG encoder (Sub filter, zlib level 1: decoding gives the
        same pixels at any level, and the low one is the fast one)."""
        for sub in ("renders", "gt", "vis"):
            os.makedirs(os.path.join(path, sub), exist_ok=True)

        def save(arr, sub, name):
            img = (torch.clamp(arr, 0, 1) * 255).to(torch.uint8)
            encode_png(os.path.join(path, sub, name), img.cpu().numpy(),
                       level=1)

        for idx, cd in enumerate(self.viewpoints):
            save(self.rgbmaps[idx].permute(1, 2, 0), "renders",
                 f"{idx:05d}.png")
            if cd.image is not None:
                save(torch.as_tensor(cd.image).permute(1, 2, 0), "gt",
                     f"{idx:05d}.png")
            d = self.depthmaps[idx][0]
            save(torch.stack([d / max(float(d.max()), 1e-6)] * 3, -1),
                 "vis", f"depth_{idx:05d}.png")
            save(self.normalmaps[idx].permute(1, 2, 0) * 0.5 + 0.5,
                 "vis", f"normal_{idx:05d}.png")


def post_process_mesh(verts, faces, colors=None, num_cluster=50):
    """Keep the num_cluster largest edge-connected components, dropping
    clusters under the reference's 50-triangle floor
    (utils/mesh_utils.py:22-43: threshold = max(num_cluster-th largest
    size, 50))."""
    v2, f2, used = largest_clusters(verts, faces, num_clusters=num_cluster,
                                    min_faces=50)
    c2 = colors[used] if colors is not None else None
    return v2, f2, c2


def save_mesh(path, verts, faces, colors=None):
    write_mesh_ply(path, verts, faces, colors)
