"""DTU chamfer evaluation protocol.

Counterpart of ``gs2d_tpu/eval/dtu.py``: the same protocol, the same
numbers. The card's machine has no OpenCV, so the three cv2 calls there
have replacements here that give cv2's results:

- ``decompose_projection`` for ``cv2.decomposeProjectionMatrix``: an RQ
  decomposition (``scipy.linalg.rq``) with cv2's convention (K's first two
  diagonal entries positive, R a rotation, K[2, 2] carrying the sign of
  det M), the camera centre as the homogeneous null vector of P;
- ``ellipse_footprint`` for ``cv2.getStructuringElement(MORPH_ELLIPSE)``,
  built row by row as OpenCV builds it, and ``dilate`` for ``cv2.dilate``
  with it: a ``F.conv2d`` of the 0/1 mask with the footprint on
  ``device`` (at most (2r+1)^2 ones summed: exact in FP32), pixels outside
  the image counting as background;
- ``read_mask_gray`` for ``cv2.imread(p, IMREAD_GRAYSCALE)``: the port's
  PNG decoder, then the RGB to gray conversion OpenCV's PNG reader asks of
  libpng (``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``: coefficients
  9797, 19234, 3737 in 15 bits, truncated, gray pixels passed through) for
  colour masks. A pixel (1, 0, 0) becomes 0, so "any channel > 0" is not
  the same test.

Mirrors the reference's scripts/eval_dtu/ (evaluate_single_scene.py:19-101
+ eval.py:43-166): cull the reconstructed mesh by the per-view dilated
image masks, sample it to a point cloud at 0.2 density, filter by the
dataset's ObsMask / bounding box / plane, then measure bidirectional mean
distances against the structured-light GT points (outliers clipped at
max_dist = 20 mm). Requires the official DTU evaluation data
(ObsMask{scan}_10.mat, Points/stl{scan}_total_ply) when available;
without them, falls back to a plain clipped chamfer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F

from ..scene.images import decode_png
from ..scene.ply import read_mesh_ply, read_point_cloud
from .geometry import (chamfer_distance, nn_distances,
                       sample_mesh_points, thin_points)


def decompose_projection(P: np.ndarray):
    """``cv2.decomposeProjectionMatrix(P)[:3]`` for a 3x4 P: (K, R, c),
    P[:, :3] = K @ R with K upper triangular, K[0, 0] and K[1, 1] positive
    and R a rotation; c (4, 1) the homogeneous camera centre, P @ c = 0."""
    P = np.asarray(P, np.float64)
    K, R = scipy.linalg.rq(P[:, :3])
    D = np.diag(np.sign(np.where(np.diag(K) == 0, 1.0, np.diag(K))))
    K, R = K @ D, D @ R
    if np.linalg.det(R) < 0:            # cv2 keeps R proper: K[2, 2] < 0
        K[:, 2] *= -1
        R[2] *= -1
    c = np.linalg.svd(np.vstack([P, np.zeros((1, 4))]))[2][-1]
    return K, R, c[:, None]


def ellipse_footprint(width: int, height: int) -> np.ndarray:
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (width, height))``:
    per row i, the columns c - dx .. c + dx with dy = i - r and
    dx = round(c * sqrt((r^2 - dy^2) / r^2)) (r = height // 2,
    c = width // 2, rounding half to even as cvRound does)."""
    if (width, height) == (1, 1):
        return np.ones((1, 1), np.uint8)
    r, c = height // 2, width // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((height, width), np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, width)] = 1
    return out


def dilate(mask: np.ndarray, footprint: np.ndarray,
           device="cuda") -> np.ndarray:
    """``cv2.dilate(mask, footprint) > 0`` for a 0/1 mask and a footprint
    of odd sides anchored at its centre, as a bool array: pixels outside
    the image are background. Computed on ``device`` as a convolution of
    the mask with the footprint (the sums are small integers, exact in
    FP32)."""
    kh, kw = footprint.shape
    m = torch.as_tensor(np.asarray(mask, np.float32), device=device)
    k = torch.as_tensor(footprint[::-1, ::-1].astype(np.float32).copy(),
                        device=device)
    s = F.conv2d(m[None, None], k[None, None],
                 padding=(kh // 2, kw // 2))[0, 0]
    return (s > 0.5).cpu().numpy()


def read_mask_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for an 8-bit PNG: gray as
    stored (gray+alpha: the gray), RGB and RGBA through libpng's
    rgb_to_gray as OpenCV sets it up, alpha ignored."""
    img = decode_png(path)
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:
        return img[..., 0]
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    gray = (r * 9797 + g * 19234 + b * 3737) >> 15
    return np.where((r == g) & (g == b), r, gray).astype(np.uint8)


def load_idr_cameras(cameras_npz_path: str, n_images: int):
    """Load the IDR-format `cameras.npz` shipped with the preprocessed DTU
    scans (the reference reads it at evaluate_single_scene.py:25-37):
    per-view `world_mat_i` (K[R|t] in the normalized frame composed with
    `scale_mat_i`). Returns (intrinsics[n,3,3], w2c[n,4,4], scale_mat0)."""
    cd = np.load(cameras_npz_path)
    Ks, w2cs = [], []
    for i in range(n_images):
        P = (cd[f"world_mat_{i}"] @ cd[f"scale_mat_{i}"])[:3, :4]
        K, R, t = decompose_projection(P)
        K = K / K[2, 2]
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = R.T
        pose[:3, 3] = (t[:3] / t[3])[:, 0]
        Ks.append(K.astype(np.float32))
        w2cs.append(np.linalg.inv(pose).astype(np.float32))
    return np.stack(Ks), np.stack(w2cs), cd["scale_mat_0"].astype(np.float32)


def cull_mesh_by_masks(verts, faces, masks, Ks, w2cs,
                       dilate_radius: int = 24, scale_mat=None,
                       device="cuda"):
    """The reference's mask culling (evaluate_single_scene.py:19-101):
    a vertex survives iff in EVERY view it is either outside the image or
    inside that view's disk(24)-dilated foreground mask; faces with any
    culled vertex are dropped, and the surviving vertices are mapped to
    the GT world frame via `scale_mat` (v' = v·s + t). Mask resolution is
    taken from the mask arrays (the reference hard-codes 1600x1200). The
    dilation runs on ``device``."""
    keep_v = np.ones(len(verts), bool)
    vh = np.concatenate([verts, np.ones((len(verts), 1))], -1)
    kernel = ellipse_footprint(2 * dilate_radius + 1, 2 * dilate_radius + 1)
    for K, w2c, mask in zip(Ks, w2cs, masks):
        H, W = mask.shape[:2]
        m = dilate((mask > 0).astype(np.uint8), kernel, device)
        p = vh @ w2c.T
        cp = p[:, :3] @ K.T
        u = cp[:, 0] / (cp[:, 2] + 1e-6)
        v = cp[:, 1] / (cp[:, 2] + 1e-6)
        # strict open-interval validity, as the reference's (-1,1) check
        valid = (u > 0) & (u < W - 1) & (v > 0) & (v < H - 1)
        ui = np.clip(np.rint(u).astype(int), 0, W - 1)
        vi = np.clip(np.rint(v).astype(int), 0, H - 1)
        keep_v &= np.where(valid, m[vi, ui], True)
    fmask = keep_v[faces].all(-1)
    if scale_mat is not None:
        verts = verts * scale_mat[0, 0] + scale_mat[:3, 3][None]
    return verts, faces[fmask]


def cull_mesh_for_scan(mesh_verts, mesh_faces, scan_dir: str,
                       dilate_radius: int = 24, device="cuda"):
    """Full reference cull step for one preprocessed DTU scan directory
    (must contain `cameras.npz` and `mask/*.png`). Returns (verts, faces)
    in the GT world frame, or None if the directory lacks the data."""
    import glob

    cam_file = os.path.join(scan_dir, "cameras.npz")
    mask_paths = sorted(glob.glob(os.path.join(scan_dir, "mask", "*.png")))
    if not (os.path.exists(cam_file) and mask_paths):
        return None
    masks = [read_mask_gray(p) for p in mask_paths]
    Ks, w2cs, scale_mat = load_idr_cameras(cam_file, len(mask_paths))
    return cull_mesh_by_masks(mesh_verts, mesh_faces, masks, Ks, w2cs,
                              dilate_radius=dilate_radius,
                              scale_mat=scale_mat, device=device)


def evaluate_scan(mesh_path: str, gt_points_path: str,
                  obs_mask_path: Optional[str] = None,
                  density: float = 0.2, max_dist: float = 20.0,
                  n_samples: int = 2_000_000,
                  scan_dir: Optional[str] = None, device="cuda") -> dict:
    """Chamfer for one scan. When ``scan_dir`` holds the preprocessed DTU
    `cameras.npz` + `mask/`, the mesh is mask-culled first (its dilations
    on ``device``), as the reference protocol requires
    (evaluate_single_scene.py:19-101)."""
    verts, faces, _ = read_mesh_ply(mesh_path)
    if scan_dir is not None:
        culled = cull_mesh_for_scan(verts, faces, scan_dir, device=device)
        if culled is not None:
            verts, faces = culled
    return evaluate_scan_mesh(verts, faces, gt_points_path, obs_mask_path,
                              density=density, max_dist=max_dist,
                              n_samples=n_samples)


def evaluate_scan_mesh(verts, faces, gt_points_path: str,
                       obs_mask_path: Optional[str] = None,
                       density: float = 0.2, max_dist: float = 20.0,
                       n_samples: int = 2_000_000,
                       plane_path: Optional[str] = None) -> dict:
    """Reference eval.py:43-158 point-filter pipeline:

      data (sampled mesh + vertices, thinned) →
        bbox filter [BB0−60, BB1+120)          → data_in
        ObsMask filter on data_in              → data_grid_in
      d2s (accuracy)     = NN(data_grid_in → stl)
      s2d (completeness) = NN(stl above plane → data_in)   ← bbox-only!

    The ground plane lives in a SEPARATE Plane{scan}.mat in official DTU
    data (ObsMask{scan}_10.mat has only ObsMask/BB/Res) — resolved from
    plane_path, a sibling Plane file, or an inline 'P' key (fixtures).
    Sample count scales with the culled surface area so point spacing
    stays under the thinning radius (the reference samples a ~0.2 mm
    triangle grid, whose density is area-derived)."""
    # area-derived sample count: ≥4 samples per density² cell
    tri = verts[faces]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), -1).sum()
    if density > 0:
        n_samples = int(min(max(n_samples, 4 * area / density ** 2),
                            20_000_000))
    pts = sample_mesh_points(verts, faces, n_samples)
    # reference keeps the mesh vertices too — but only REFERENCED ones
    # (its cull step removes unreferenced vertices; ours filters faces
    # only, so culled-away floater vertices must not sneak back in)
    used = np.zeros(len(verts), bool)
    used[np.asarray(faces).ravel()] = True
    pts = np.concatenate([pts, verts[used]], 0)
    pts = thin_points(pts, density) if density > 0 else pts

    gt, _, _ = read_point_cloud(gt_points_path)

    if obs_mask_path and os.path.exists(obs_mask_path):
        import re

        import scipy.io as sio
        md = sio.loadmat(obs_mask_path)
        obs_mask, bb = md["ObsMask"], md["BB"]
        res = float(np.asarray(md["Res"]).ravel()[0])
        patch = 60.0
        inb = ((pts >= bb[0] - patch) & (pts < bb[1] + 2 * patch)).all(-1)
        data_in = pts[inb]
        gidx = ((data_in - bb[0]) / res).round().astype(int)
        ok = ((gidx >= 0) & (gidx < np.array(obs_mask.shape))).all(-1)
        sel = np.zeros(len(data_in), bool)
        sel[ok] = obs_mask[tuple(gidx[ok].T)] > 0
        data_grid_in = data_in[sel]

        plane = md.get("P")
        if plane is None:
            cand = plane_path
            if cand is None:
                m = re.search(r"(\d+)", os.path.basename(obs_mask_path))
                if m:
                    cand = os.path.join(os.path.dirname(obs_mask_path),
                                        f"Plane{m.group(1)}.mat")
            if cand and os.path.exists(cand):
                plane = sio.loadmat(cand)["P"]
        gt_above = gt
        if plane is not None:
            h = np.concatenate([gt, np.ones((len(gt), 1))], -1) @ plane
            gt_above = gt[h[:, 0] > 0]

        # empty filtered sets mean the mesh lies wholly outside the
        # scored region (e.g. wrong frame without cull) — score inf,
        # not nan, so comparisons still order it as "worse than anything"
        d2s = (float(np.mean(np.minimum(
            nn_distances(data_grid_in, gt), max_dist)))
            if len(data_grid_in) else float("inf"))
        s2d = (float(np.mean(np.minimum(
            nn_distances(gt_above, data_in), max_dist)))
            if len(data_in) and len(gt_above) else float("inf"))
    else:
        d2s, s2d = chamfer_distance(pts, gt, max_dist=max_dist)

    return {"mean_d2s": d2s, "mean_s2d": s2d,
            "overall": (d2s + s2d) / 2.0}
