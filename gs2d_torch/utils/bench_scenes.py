"""Trained-scene-like synthetic scenes for benchmarking.

NumPy copy of ``gs2d_tpu/utils/bench_scenes.py`` (the port imports nothing
from the JAX package); the same seed gives the same arrays. Besides it:
``build_uniform_scene`` (``bench.py:200-207``) and ``bench_state``, the
trained-like scene as a ``GaussianState`` at SH degree 3, which
``gs2d_torch.cli.bench`` and ``chip_smoke.py`` train and render.

The round-1 bench used 100k uniform random Gaussians (~520k tile pairs at
1080p) — far below the multi-million pair counts of real trained scenes
(SURVEY.md §7 hard-part 3: ~10^7 duplicated keys/frame). Trained 2DGS
scenes concentrate surfels ON SURFACES with a heavy-tailed scale
distribution and mostly-opaque splats (reference densification clones
small / splits large and prunes low-alpha, scene/gaussian_model.py:348-403
in the reference). This module builds a synthetic analog whose pair
count, depth complexity, and opacity histogram are in the trained-scene
regime, scaled to any N.

Geometry: a torus + ground-plane disc + far background shell, camera at
~3 units looking at the origin. Scales are log-normal around a per-N
surface-coverage base so that average depth complexity stays ~``overlap``
regardless of N (more splats → smaller splats, as densification produces).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gaussians import GaussianParams, GaussianState
from ..ops.sh import rgb_to_sh


def make_trained_like_scene(n: int, seed: int = 0, overlap: float = 3.0):
    """Return numpy (means[N,3], scales[N,2], quats[N,4], opacity[N], rgb[N,3]).

    ``overlap`` multiplies the coverage-balanced splat radius; ~3 gives
    trained-scene-like depth complexity (each surface point covered by
    ~overlap^2 splats) and multi-million 1080p tile pairs at N >= 5e5.
    """
    rng = np.random.default_rng(seed)
    n_torus = int(n * 0.60)
    n_plane = int(n * 0.25)
    n_shell = n - n_torus - n_plane

    # --- torus surface (R=1.0, r=0.35) -------------------------------
    R, r = 1.0, 0.35
    theta = rng.uniform(0, 2 * np.pi, n_torus)
    phi = rng.uniform(0, 2 * np.pi, n_torus)
    pts_t = np.stack([np.cos(theta) * (R + r * np.cos(phi)),
                      np.sin(theta) * (R + r * np.cos(phi)),
                      r * np.sin(phi)], -1)
    ring = np.stack([R * np.cos(theta), R * np.sin(theta), 0 * theta], -1)
    nrm_t = (pts_t - ring) / r
    area_t = 4 * np.pi**2 * R * r

    # --- ground plane disc (z = -0.4, radius 3) ----------------------
    rad = 3.0 * np.sqrt(rng.uniform(0, 1, n_plane))
    ang = rng.uniform(0, 2 * np.pi, n_plane)
    pts_p = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                      np.full(n_plane, -0.4)], -1)
    nrm_p = np.tile(np.array([0.0, 0.0, 1.0]), (n_plane, 1))
    area_p = np.pi * 3.0**2

    # --- far background shell (radius 6) -----------------------------
    u = rng.normal(size=(n_shell, 3))
    u /= np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-8)
    pts_s = 6.0 * u
    nrm_s = -u
    area_s = 4 * np.pi * 6.0**2

    pts = np.concatenate([pts_t, pts_p, pts_s]).astype(np.float32)
    nrm = np.concatenate([nrm_t, nrm_p, nrm_s]).astype(np.float32)

    # Coverage-balanced base radius per group, then log-normal spread
    # (trained scale histograms are heavy-tailed; sigma=0.5 in log space).
    base = np.concatenate([
        np.full(n_torus, np.sqrt(area_t / max(n_torus, 1) / np.pi)),
        np.full(n_plane, np.sqrt(area_p / max(n_plane, 1) / np.pi)),
        np.full(n_shell, np.sqrt(area_s / max(n_shell, 1) / np.pi)),
    ])
    lognorm = np.exp(rng.normal(0.0, 0.5, n))
    s_iso = (overlap * base * lognorm).astype(np.float32)
    # anisotropy: one axis stretched up to 3x (surfels elongate along edges)
    aniso = np.exp(rng.uniform(0, np.log(3.0), n)).astype(np.float32)
    scales = np.stack([s_iso * np.sqrt(aniso), s_iso / np.sqrt(aniso)], -1)

    # Quats: align local z to the surface normal, then random in-plane spin.
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(np.tile(z, (n, 1)), nrm)
    w = 1.0 + nrm @ z
    quat = np.concatenate([w[:, None], v], -1)
    # degenerate case (normal == -z): use a 180° flip about x
    bad = np.linalg.norm(quat, axis=-1) < 1e-6
    quat[bad] = np.array([0.0, 1.0, 0.0, 0.0])
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    spin = rng.uniform(0, 2 * np.pi, n)
    qs = np.stack([np.cos(spin / 2), 0 * spin, 0 * spin,
                   np.sin(spin / 2)], -1)
    # quaternion product quat * qs (w,x,y,z)
    w1, x1, y1, z1 = quat.T
    w2, x2, y2, z2 = qs.T
    quats = np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1).astype(np.float32)

    # Opacity: trained scenes are mostly near-opaque with a low-alpha tail
    # (prune threshold 0.05). 1 - u^3 skews high.
    opac = (1.0 - rng.uniform(0, 1, n) ** 3).astype(np.float32)
    opac = np.clip(opac, 0.05, 0.995)

    rgb = rng.random((n, 3)).astype(np.float32)
    return pts, scales, quats, opac, rgb


def build_uniform_scene(n: int, seed: int = 0):
    """``bench.py``'s historical scene: ``n`` uniform random Gaussians in
    a 3-unit cube, as (means, scales, quats, opacity, rgb) NumPy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
            rng.uniform(0.004, 0.02, (n, 2)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
            rng.uniform(0.3, 0.9, (n,)).astype(np.float32),
            rng.random((n, 3)).astype(np.float32))


def bench_state(n: int, *, rest_seed=None, device="cuda"):
    """``make_trained_like_scene(n)`` as a ``GaussianState`` at SH degree
    3 on ``device``: DC colours from its rgb, opacities clipped to
    [1e-4, 1 − 1e-4] before the logit (``bench.py:157-168``). The 45 SH
    rest coefficients are zero, as the JAX bench has them, or with
    ``rest_seed`` normal draws of scale 0.1 from that seed."""
    means, scales, quats, opac, rgb = make_trained_like_scene(n)
    if rest_seed is None:
        rest = np.zeros((n, 15, 3), np.float32)
    else:
        rest = (np.random.default_rng(rest_seed).normal(size=(n, 15, 3))
                * 0.1).astype(np.float32)
    opac = np.clip(opac, 1e-4, 1 - 1e-4)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)

    return GaussianState(params=GaussianParams(
        xyz=dev(means), features_dc=dev(rgb_to_sh(rgb)[:, None, :]),
        features_rest=dev(rest), scaling=dev(np.log(scales)),
        rotation=dev(quats),
        opacity=dev(np.log(opac / (1 - opac))[:, None])),
        active_sh_degree=3)
