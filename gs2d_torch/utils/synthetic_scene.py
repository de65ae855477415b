"""Synthetic multi-view datasets on disk, rendered by the port.

Counterpart of ``scripts/make_synthetic_scene.py``: a structured surfel
cloud (the coloured torus of oriented disks, or the trained-like scene of
``bench_scenes.py`` with procedural multi-scale colours) rendered from an
orbit around the origin through ``render()``, written with the port's PNG
encoder as a Blender/NeRF-synthetic scene (RGBA PNGs and
``transforms_{train,test}.json``) or as a COLMAP scene (RGB PNGs under
``images/`` and a binary ``sparse/0`` with one PINHOLE camera), so the
loaders and the CLIs run end to end without an external dataset.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from ..models.gaussians import GaussianParams, GaussianState
from ..ops.transforms import fov2focal
from ..render.renderer import render
from ..scene.cameras import make_camera
from ..scene.colmap import (ColmapCamera, ColmapImage, rotmat2qvec,
                            write_cameras_binary, write_images_binary,
                            write_points3d_binary)
from ..scene.images import encode_png
from ..scene.ply import write_point_cloud
from .bench_scenes import make_trained_like_scene


def torus_surfels(n=4000, R=0.8, r=0.3, seed=0):
    """The coloured torus (``make_synthetic_scene.py:22-46``) → (pts,
    scales, quats, opacity, rgb)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    cx = np.cos(theta) * (R + r * np.cos(phi))
    cy = np.sin(theta) * (R + r * np.cos(phi))
    cz = r * np.sin(phi)
    pts = np.stack([cx, cy, cz], -1).astype(np.float32)
    ring = np.stack([R * np.cos(theta), R * np.sin(theta), 0 * theta], -1)
    nrm = (pts - ring) / r
    # quaternion aligning the disk normal (local z) to nrm
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(np.tile(z, (n, 1)), nrm)
    w = 1.0 + nrm @ z
    quat = np.concatenate([w[:, None], v], -1)
    quat /= np.maximum(np.linalg.norm(quat, axis=-1, keepdims=True), 1e-8)
    rgb = np.stack([0.5 + 0.5 * np.cos(theta),
                    0.5 + 0.5 * np.sin(2 * phi),
                    0.5 + 0.5 * np.sin(theta + phi)], -1).astype(np.float32)
    scales = np.full((n, 2), 0.035, np.float32)
    opac = np.full((n,), 0.85, np.float32)
    return pts, scales, quat.astype(np.float32), opac, rgb


def rich_surfels(n=300_000, seed=0):
    """Trained-like geometry with the procedural colours of
    ``make_synthetic_scene.py:49-71`` (coarse bands plus fine stripes at
    2, 9 and 31 cycles across the scene)."""
    pts, scales, quat, opac, _ = make_trained_like_scene(
        n, seed=seed, overlap=2.0)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rgb = np.stack([
        0.55 + 0.25 * np.sin(2.0 * x) * np.cos(2.0 * y)
        + 0.20 * np.sin(9.0 * (x + z)),
        0.50 + 0.30 * np.cos(2.0 * z + 9.0 * y)
        + 0.15 * np.sin(31.0 * x),
        0.45 + 0.25 * np.sin(9.0 * (y - z))
        + 0.20 * np.cos(31.0 * (x + y)),
    ], -1).astype(np.float32)
    return pts, scales, quat, np.clip(opac, 0.3, 0.995), np.clip(rgb, 0, 1)


def seed_cloud(pts, rgb, n=30_000):
    """A COLMAP-like sparse seed: ground-truth positions and colours with
    noise (``make_synthetic_scene.py:175-190``) → (xyz, rgb in [0, 1])."""
    rng = np.random.default_rng(7)
    n = min(n, len(pts))
    sel = rng.choice(len(pts), n, replace=False)
    xyz = pts[sel] + rng.normal(scale=0.01, size=(n, 3)).astype(np.float32)
    cols = np.clip(rgb[sel] + rng.normal(scale=0.05, size=(n, 3)), 0, 1)
    return xyz.astype(np.float32), cols.astype(np.float32)


def orbit_c2w(theta, elev=0.5, dist=3.2):
    """OpenGL-convention camera on an orbit looking at the origin."""
    eye = np.array([dist * math.cos(theta) * math.cos(elev),
                    dist * math.sin(theta) * math.cos(elev),
                    dist * math.sin(elev)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up
    c2w[:3, 2] = -fwd          # OpenGL: camera looks along -z
    c2w[:3, 3] = eye
    return c2w


def orbit(n, test=False):
    """The views of ``make_synthetic_scene.py:195-197``: n thetas round
    the circle (test views half a step on), elevation 0.35 + 0.3 sin 3.1θ."""
    out = []
    for i in range(n):
        theta = 2 * np.pi * (i + (0.5 if test else 0)) / n
        out.append(orbit_c2w(theta, 0.35 + 0.3 * math.sin(3.1 * theta)))
    return out


def w2c_of(c2w):
    """OpenGL c2w → COLMAP-convention world→camera 4×4."""
    c2w_cv = np.array(c2w, np.float64)
    c2w_cv[:3, 1:3] *= -1
    return np.linalg.inv(c2w_cv)


class SurfelRenderer:
    """Renders a surfel cloud with fixed colours (no SH) on ``device``."""

    def __init__(self, surfels, device="cuda"):
        pts, scales, quats, opac, rgb = surfels
        opac = np.clip(opac, 1e-4, 1 - 1e-4)
        n = len(pts)

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                   device=device)

        self.device = torch.device(device)
        self.state = GaussianState(params=GaussianParams(
            xyz=dev(pts), features_dc=torch.zeros((n, 1, 3), device=device),
            features_rest=torch.zeros((n, 0, 3), device=device),
            scaling=dev(np.log(scales)), rotation=dev(quats),
            opacity=dev(np.log(opac / (1 - opac))[:, None])),
            active_sh_degree=0)
        self.rgb = dev(rgb)

    @torch.no_grad()
    def rgba(self, c2w, width, height, fovx, bg=0.0) -> np.ndarray:
        """uint8 (H, W, 4): colour over ``bg``, and alpha."""
        fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
        w2c = w2c_of(c2w)
        cam = make_camera(w2c[:3, :3].T, w2c[:3, 3], fovx, fovy, width,
                          height, device=self.device)
        bgv = torch.full((3,), float(bg), device=self.device)
        pkg = render(cam, self.state, bgv, max_sh_degree=0,
                     override_color=self.rgb, device=self.device)
        alpha = torch.clamp(pkg["rend_alpha"], 0, 1)
        img = torch.clamp(pkg["render"], 0, 1)
        out = torch.cat([img, alpha], 0).permute(1, 2, 0)
        return (out * 255).to(torch.uint8).cpu().numpy()


def write_blender_scene(out, renderer: SurfelRenderer, width, height,
                        n_train, n_test, fovx=math.radians(50.0),
                        white_background=False, seed_points=None):
    """RGBA PNGs ``{train,test}/r_<i>.png`` and their transforms, as
    ``make_synthetic_scene.py`` writes them; ``seed_points`` (xyz, rgb)
    becomes ``points3d.ply``, else the loader draws its random init."""
    os.makedirs(out, exist_ok=True)
    if seed_points is not None:
        write_point_cloud(os.path.join(out, "points3d.ply"), *seed_points)
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(out, split), exist_ok=True)
        frames = []
        for i, c2w in enumerate(orbit(n, test=split == "test")):
            img = renderer.rgba(c2w, width, height, fovx,
                                bg=1.0 if white_background else 0.0)
            encode_png(os.path.join(out, split, f"r_{i}.png"), img)
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)


def write_colmap_scene(out, renderer: SurfelRenderer, width, height,
                       n_views, seed_points, fovx=math.radians(70.0)):
    """RGB PNGs ``images/<i:03d>.png`` of the orbit's n_views views over a
    black background, and a binary ``sparse/0``: one PINHOLE camera
    (fx = fy, the principal point at the centre), the views' poses and
    ``seed_points`` (xyz, rgb in [0, 1]) as points3D.bin. The PNGs are
    Sub-filtered at zlib level 1: the fast encode, the same pixels."""
    img_dir = os.path.join(out, "images")
    model_dir = os.path.join(out, "sparse", "0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(model_dir, exist_ok=True)
    f = fov2focal(fovx, width)
    write_cameras_binary({1: ColmapCamera(
        1, "PINHOLE", width, height,
        np.array([f, f, width / 2.0, height / 2.0]))},
        os.path.join(model_dir, "cameras.bin"))
    images = {}
    for i, c2w in enumerate(orbit(n_views)):
        name = f"{i:03d}.png"
        encode_png(os.path.join(img_dir, name),
                   renderer.rgba(c2w, width, height, fovx)[..., :3],
                   level=1)
        w2c = w2c_of(c2w)
        images[i + 1] = ColmapImage(i + 1, rotmat2qvec(w2c[:3, :3]),
                                    w2c[:3, 3], 1, name, np.zeros((0, 2)),
                                    np.zeros((0,), np.int64))
    write_images_binary(images, os.path.join(model_dir, "images.bin"))
    xyz, rgb = seed_points
    write_points3d_binary(xyz.astype(np.float64),
                          np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8),
                          os.path.join(model_dir, "points3D.bin"))
