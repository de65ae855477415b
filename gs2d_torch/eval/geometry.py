"""Geometry evaluation primitives: mesh sampling, chamfer, F-score, ICP.

The port's copy of ``gs2d_tpu/eval/geometry.py``, line for line in its
arithmetic (host NumPy/SciPy in both packages; the port cannot import the
JAX package's module, whose package imports jax); the nearest-neighbour
queries use every host core. Capability of the
reference's scripts/eval_dtu (chamfer protocol, eval.py:43-166) and
scripts/eval_tnt (precision/recall/F1 with trajectory + ICP refinement,
evaluation.py:60-215, registration.py:65-199), built on scipy cKDTree
instead of Open3D/sklearn.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def sample_mesh_points(verts: np.ndarray, faces: np.ndarray,
                       n_points: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling."""
    tri = verts[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    if area.sum() <= 0:
        # a degenerate/fully-culled mesh must fail loudly — silently
        # scoring the raw (possibly culled-away) vertices produces a
        # plausible-looking chamfer for garbage input
        raise ValueError(
            "mesh has zero total surface area (all faces culled?)")
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(faces), n_points, p=area / area.sum())
    u = rng.random(n_points)
    v = rng.random(n_points)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    t = tri[idx]
    return (t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0])
            + v[:, None] * (t[:, 2] - t[:, 0]))


def thin_points(points: np.ndarray, density: float) -> np.ndarray:
    """Min-distance thinning (the DTU eval's reducePts semantics:
    greedy random-order filter keeping no two points within ``density``).

    Two-phase for speed at protocol scale AND robustness to clustered
    clouds: (1) a vectorized voxel dedup at density/sqrt(3) — any two
    points in one voxel are within density, so greedy would keep exactly
    one of them anyway (which one is within the protocol's own
    random-order variance); (2) exact greedy thinning over the survivors
    with one BATCHED radius query (ball sizes are now O(10), unlike the
    reference fixture pathology where per-ball membership reaches 1e5
    and precomputing 2M such lists explodes)."""
    if len(points) == 0:
        return points
    vox = density / np.sqrt(3.0)
    keys = np.floor((points - points.min(0)) / vox).astype(np.int64)
    # np.unique(keys, axis=0, return_index=True) of the JAX package on one
    # int64 key per voxel (keys are >= 0): the same first members, without
    # the row-wise sort that costs seconds at millions of points
    span = keys.max(axis=0) + 1
    if float(span[0]) * float(span[1]) * float(span[2]) >= 2.0 ** 62:
        raise ValueError(f"thin_points: {span.tolist()} voxels per axis do "
                         "not fit one int64 key")
    flat = (keys[:, 0] * span[1] + keys[:, 1]) * span[2] + keys[:, 2]
    _, first = np.unique(flat, return_index=True)
    pts = points[np.sort(first)]

    tree = cKDTree(pts)
    neighbors = tree.query_ball_point(pts, density, workers=-1)
    keep = np.ones(len(pts), bool)
    order = np.random.default_rng(0).permutation(len(pts))
    for i in order:
        if not keep[i]:
            continue
        for j in neighbors[i]:
            if j != i:
                keep[j] = False
        keep[i] = True
    return pts[keep]


def nn_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each point in a, distance to nearest point in b (the queries
    spread over the host's cores; each is independent, so the distances
    are those of one thread)."""
    return cKDTree(b).query(a, k=1, workers=-1)[0]


def chamfer_distance(data: np.ndarray, gt: np.ndarray,
                     max_dist: float = np.inf) -> Tuple[float, float]:
    """(accuracy d2s, completeness s2d) with outlier clipping at max_dist
    (the DTU convention)."""
    d2s = nn_distances(data, gt)
    s2d = nn_distances(gt, data)
    d2s = d2s[d2s < max_dist]
    s2d = s2d[s2d < max_dist]
    return float(d2s.mean()) if len(d2s) else np.inf, \
        float(s2d.mean()) if len(s2d) else np.inf


def fscore(reconstruction: np.ndarray, gt: np.ndarray,
           threshold: float) -> dict:
    """TnT-style precision / recall / F1 at distance threshold τ."""
    d_r2g = nn_distances(reconstruction, gt)
    d_g2r = nn_distances(gt, reconstruction)
    precision = float((d_r2g < threshold).mean()) if len(d_r2g) else 0.0
    recall = float((d_g2r < threshold).mean()) if len(d_g2r) else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "fscore": f1}


def icp_point_to_point(src: np.ndarray, dst: np.ndarray,
                       max_iterations: int = 30,
                       max_corr_dist: float = 0.1,
                       init: Optional[np.ndarray] = None) -> np.ndarray:
    """Rigid point-to-point ICP; returns a 4×4 transform src→dst."""
    T = np.eye(4) if init is None else init.copy()
    tree = cKDTree(dst)
    cur = src @ T[:3, :3].T + T[:3, 3]
    prev_err = np.inf
    for _ in range(max_iterations):
        d, j = tree.query(cur, k=1, workers=-1)
        m = d < max_corr_dist
        if m.sum() < 3:
            break
        p = cur[m]
        q = dst[j[m]]
        pc = p - p.mean(0)
        qc = q - q.mean(0)
        H = pc.T @ qc
        U, _, Vt = np.linalg.svd(H)
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[-1] *= -1
            R = Vt.T @ U.T
        t = q.mean(0) - R @ p.mean(0)
        delta = np.eye(4)
        delta[:3, :3] = R
        delta[:3, 3] = t
        T = delta @ T
        cur = src @ T[:3, :3].T + T[:3, 3]
        err = d[m].mean()
        if abs(prev_err - err) < 1e-9:
            break
        prev_err = err
    return T
