"""Scenes, camera rigs and ground truth, made from a configuration and a
seed.

The surfels follow the trained-scene generator of the port's benchmark
(``gs2d_torch/utils/bench_scenes.py::make_trained_like_scene``, copied
here rather than imported, and moved onto the device): surfels lie on
surfaces, oriented along the surface normal with a random in-plane spin,
with log-normal sizes balanced so that each surface point is covered by
about ``overlap``² surfels whatever their number, one axis stretched up
to ``aniso_max`` times, opacities skewed towards opaque (1 − u³, clipped
to [0.05, 0.995]) and SH colours. A configuration lists its surfaces as
groups of a few kinds (``ellipsoids``, ``disc``, ``shell``, ``box``),
each with its share of the surfels. Everything is drawn on the device by
one ``torch.Generator`` seeded with the run's seed, in a few large calls.

The camera rig never depends on the seed: a ring of ``views`` cameras
around ``look_at``, every ``holdout``-th one held out for testing, as
the Mip-NeRF 360 protocol holds out every 8th image.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from .reference.raster import View

SH_C0 = 0.28209479177387814


def _unit(g: torch.Generator, n: int, device) -> torch.Tensor:
    u = torch.randn((n, 3), generator=g, device=device)
    return u / torch.clamp(torch.linalg.vector_norm(u, dim=-1,
                                                    keepdim=True), min=1e-8)


def _uniform(g, n, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device)


def _group(spec: dict, n: int, g: torch.Generator, device):
    """(points, normals, area) of ``n`` surfels on one group's surface."""
    kind = spec["kind"]
    if kind == "ellipsoids":
        k = int(spec["count"])
        centers = torch.as_tensor(spec["centers"], dtype=torch.float32,
                                  device=device).reshape(k, 3)
        radii = torch.as_tensor(spec["radii"], dtype=torch.float32,
                                device=device).reshape(k, 3)
        a, b, c = radii.unbind(-1)
        p = 1.6
        areas = 4 * math.pi * (((a * b) ** p + (a * c) ** p + (b * c) ** p)
                               / 3) ** (1 / p)
        which = torch.multinomial(areas / areas.sum(), n, replacement=True,
                                  generator=g)
        d = _unit(g, n, device)
        pts = centers[which] + d * radii[which]
        nrm = d / radii[which]
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
        return pts, nrm, float(areas.sum())
    if kind == "disc":
        r = float(spec["radius"])
        rad = r * torch.sqrt(_uniform(g, n, device))
        ang = _uniform(g, n, device, 0.0, 2 * math.pi)
        pts = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang),
                           torch.full_like(rad, float(spec["z"]))], -1)
        nrm = torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3)
        return pts, nrm.contiguous(), math.pi * r * r
    if kind == "shell":            # the sphere's part above z_min
        r = float(spec["radius"])
        z0 = max(-1.0, float(spec.get("z_min", -r)) / r)
        z = _uniform(g, n, device, z0, 1.0)    # uniform in z: uniform area
        ang = _uniform(g, n, device, 0.0, 2 * math.pi)
        rho = torch.sqrt(torch.clamp(1 - z * z, min=0.0))
        d = torch.stack([rho * torch.cos(ang), rho * torch.sin(ang), z], -1)
        return r * d, -d, 2 * math.pi * r * r * (1 - z0)
    if kind == "box":
        lo = torch.as_tensor(spec["min"], dtype=torch.float32, device=device)
        hi = torch.as_tensor(spec["max"], dtype=torch.float32, device=device)
        size = (hi - lo).tolist()
        faces = []   # (axis, side) with its area
        for ax in range(3):
            o = [size[i] for i in range(3) if i != ax]
            faces += [(ax, 0, o[0] * o[1]), (ax, 1, o[0] * o[1])]
        fa = torch.tensor([f[2] for f in faces], device=device)
        which = torch.multinomial(fa / fa.sum(), n, replacement=True,
                                  generator=g)
        u = torch.rand((n, 3), generator=g, device=device)
        pts = lo + u * (hi - lo)
        nrm = torch.zeros((n, 3), device=device)
        for i, (ax, side, _) in enumerate(faces):
            m = which == i
            pts[m, ax] = float(hi[ax] if side else lo[ax])
            nrm[m, ax] = -1.0 if side else 1.0     # facing inwards
        return pts, nrm, float(fa.sum())
    raise ValueError(f"unknown surface kind {kind!r}")


def make_params(cfg: dict, seed: int, device, n: int = 0) -> dict:
    """The scene's parameters, as the 2DGS model stores them (log scales,
    wxyz rotations, opacity logits, SH in (N, K, 3)), on ``device``.
    ``n`` overrides the configuration's surfel count (for tests)."""
    sc = cfg["scene"]
    n = int(n or cfg["n_splats"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    groups = sc["groups"]
    shares = np.array([float(s["share"]) for s in groups])
    sizes = np.floor(shares / shares.sum() * n).astype(int)
    sizes[0] += n - sizes.sum()
    pts, nrm, base = [], [], []
    for spec, m in zip(groups, sizes):
        p, q, area = _group(spec, int(m), g, device)
        pts.append(p)
        nrm.append(q)
        base.append(torch.full((int(m),), math.sqrt(area / max(m, 1)
                                                   / math.pi),
                               device=device))
    pts, nrm, base = torch.cat(pts), torch.cat(nrm), torch.cat(base)
    s_iso = float(sc["overlap"]) * base * torch.exp(
        float(sc["scale_sigma"]) * torch.randn(n, generator=g, device=device))
    aniso = torch.exp(_uniform(g, n, device, 0.0,
                               math.log(float(sc["aniso_max"]))))
    scales = torch.stack([s_iso * torch.sqrt(aniso),
                          s_iso / torch.sqrt(aniso)], -1)
    # rotate local z onto the normal, then spin about it
    z = torch.tensor([0.0, 0.0, 1.0], device=device)
    v = torch.linalg.cross(z.expand(n, 3), nrm, dim=-1)
    w = 1.0 + nrm[:, 2]
    quat = torch.cat([w[:, None], v], -1)
    bad = torch.linalg.vector_norm(quat, dim=-1) < 1e-6
    quat[bad] = torch.tensor([0.0, 1.0, 0.0, 0.0], device=device)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    spin = _uniform(g, n, device, 0.0, 2 * math.pi)
    w1, x1, y1, z1 = quat.unbind(-1)
    cs, sn = torch.cos(spin / 2), torch.sin(spin / 2)
    quats = torch.stack([w1 * cs - z1 * sn, x1 * cs + y1 * sn,
                         y1 * cs - x1 * sn, z1 * cs + w1 * sn], -1)
    opac = torch.clamp(1.0 - _uniform(g, n, device) ** 3, 0.05, 0.995)
    rgb = _uniform(g, n * 3, device).reshape(n, 3)
    rest = float(sc["sh_rest_sigma"]) * torch.randn(
        (n, 15, 3), generator=g, device=device)
    return {"xyz": pts.contiguous(),
            "features_dc": ((rgb - 0.5) / SH_C0)[:, None, :].contiguous(),
            "features_rest": rest,
            "scaling": torch.log(scales),
            "rotation": quats.contiguous(),
            "opacity": torch.log(opac / (1 - opac))[:, None]}


class Rig(NamedTuple):
    views: List[View]
    train: List[int]     # indices into views
    test: List[int]


def make_rig(cfg: dict, scale: float = 1.0) -> Rig:
    """The ring of cameras; ``scale`` shrinks the image (for tests)."""
    r = cfg["rig"]
    W = max(8, int(round(r["width"] * scale)))
    H = max(8, int(round(r["height"] * scale)))
    fovx = math.radians(float(r["fovx_deg"]))
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    target = np.asarray(r["look_at"], np.float64)
    up = np.array([0.0, 0.0, 1.0])
    views = []
    V = int(r["views"])
    for k in range(V):
        th = 2 * math.pi * k / V
        c = np.array([r["radius"] * math.cos(th), r["radius"] * math.sin(th),
                      r["height_z"] + r["height_wave"] * math.sin(3 * th)])
        f = target - c
        f /= np.linalg.norm(f)
        right = np.cross(f, up)
        right /= np.linalg.norm(right)
        down = np.cross(f, right)
        R = np.stack([right, down, f], 1)       # camera → world
        views.append(View(R, -R.T @ c, fovx, fovy, W, H))
    hold = int(r["holdout"])
    test = [k for k in range(V) if k % hold == 0]
    train = [k for k in range(V) if k % hold != 0]
    return Rig(views, train, test)


def camera_extent(views: List[View]) -> float:
    """The 3DGS/2DGS scene extent: 1.1 × the largest distance of a
    camera centre from their mean."""
    c = np.stack([-v.R @ v.t for v in views])
    return float(1.1 * np.linalg.norm(c - c.mean(0), axis=1).max())


def make_gt(n_views: int, width: int, height: int, seed: int, device,
            chunk: int = 8) -> List[torch.Tensor]:
    """One ground-truth image per training view, (3, H, W) float32 in
    [0, 1] in host memory, as a loader leaves them: drawn on the device
    from the seed in chunks, then copied back."""
    g = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    out = []
    for i in range(0, n_views, chunk):
        k = min(chunk, n_views - i)
        x = torch.rand((k, 3, height, width), generator=g, device=device)
        out.extend(x.cpu().unbind(0))
    return out
