"""Tanks & Temples evaluation protocol (full pipeline).

Counterpart of ``gs2d_tpu/eval/tnt.py``, the same code and numbers but for
two calls into matplotlib, which the card's machine does not install: the
crop polygon's ``Path.contains_points`` is ``points_in_polygon``, the
even-odd crossing test of matplotlib's ``point_in_path`` (the same
comparisons, vectorised over the points), and the precision/recall plot is
drawn only where matplotlib imports (otherwise one line says it was not;
the curves' txt files and every number are written either way).

Mirrors the reference's scripts/eval_tnt/ without Open3D:

* `.log` trajectory IO and the frame-mapping sparsification
  (trajectory_io.py, registration.py:44-62),
* trajectory alignment: RANSAC over identity camera-center
  correspondences with a similarity (Umeyama) model
  (registration.py:65-110),
* crop volume: Open3D SelectionPolygonVolume json semantics
  (run.py:152 read_selection_polygon_volume),
* three-stage ICP refinement with scaling — voxel dTau / dTau·80,
  voxel dTau/2 / dTau·20, uniform ≤4M / 2·dTau (run.py:155-160),
* EvaluateHisto: crop + voxel-downsample(dTau/2) both clouds,
  bidirectional NN distances, precision/recall/F1 at dTau, cumulative
  histograms + plots + per-scene txt outputs (evaluation.py:60-215,
  plot.py).

The reconstruction point set is the mesh vertices plus face centers,
exactly as the reference builds it (run.py:94-101).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..scene.ply import read_mesh_ply, read_point_cloud
from .geometry import fscore, icp_point_to_point, sample_mesh_points

# distance threshold τ per scene (reference config.py:33-41)
SCENES_TAU = {
    "Barn": 0.01, "Caterpillar": 0.005, "Church": 0.025,
    "Courthouse": 0.025, "Ignatius": 0.003, "Meetingroom": 0.01,
    "Truck": 0.005,
}

MAX_POINT_NUMBER = int(4e6)


# --------------------------------------------------------------------------
# trajectory IO (.log format: "<id> <id> <id>\n" + 4 matrix rows per pose)
# --------------------------------------------------------------------------

def read_trajectory_log(path: str) -> np.ndarray:
    """Read a TnT .log trajectory → (N, 4, 4) camera-to-world poses."""
    poses = []
    with open(path) as f:
        meta = f.readline()
        while meta.strip():
            rows = [np.fromstring(f.readline(), dtype=float, sep=" \t")
                    for _ in range(4)]
            poses.append(np.stack(rows))
            meta = f.readline()
    return np.stack(poses) if poses else np.zeros((0, 4, 4))


def write_trajectory_log(path: str, poses: np.ndarray) -> None:
    with open(path, "w") as f:
        for i, p in enumerate(poses):
            f.write(f"{i} {i} {i + 1}\n")
            for r in range(4):
                f.write(" ".join(f"{v:.12f}" for v in p[r]) + "\n")


def read_mapping(path: str):
    """Frame-mapping file: movie-frame index per sampled frame
    (registration.py:44-56)."""
    with open(path) as f:
        n_sampled = int(f.readline())
        n_total = int(f.readline())
        mapping = np.array([list(map(int, f.readline().split()))
                            for _ in range(n_sampled)])
    return n_sampled, n_total, mapping


def sparse_trajectory(mapping: np.ndarray, poses: np.ndarray) -> np.ndarray:
    return poses[(mapping[:, 1] - 1).astype(int)]


# --------------------------------------------------------------------------
# similarity alignment
# --------------------------------------------------------------------------

def umeyama(src: np.ndarray, dst: np.ndarray,
            with_scale: bool = True) -> np.ndarray:
    """Least-squares similarity transform dst ≈ s·R·src + t (4×4)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = (S * np.diag(D)).sum() / max(var_s, 1e-12) if with_scale else 1.0
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = mu_d - s * R @ mu_s
    return T


def ransac_trajectory_alignment(est_centers: np.ndarray,
                                gt_centers: np.ndarray,
                                threshold: float = 0.2,
                                sample_size: int = 6,
                                iterations: int = 5000,
                                seed: int = 0) -> np.ndarray:
    """Robust similarity alignment over the given 1:1 camera-center
    correspondences (the reference's RANSAC-based-on-correspondence with
    TransformationEstimationPointToPoint(with_scaling=True),
    registration.py:100-110)."""
    n = min(len(est_centers), len(gt_centers))
    src, dst = est_centers[:n], gt_centers[:n]
    if n <= sample_size:
        return umeyama(src, dst)
    rng = np.random.default_rng(seed)
    best_T, best_inl = umeyama(src, dst), -1
    for _ in range(iterations):
        idx = rng.choice(n, sample_size, replace=False)
        T = umeyama(src[idx], dst[idx])
        err = np.linalg.norm(src @ T[:3, :3].T + T[:3, 3] - dst, axis=-1)
        inl = int((err < threshold).sum())
        if inl > best_inl:
            best_inl, best_T = inl, T
            if inl == n:
                break
    # final refit on the best consensus set
    err = np.linalg.norm(src @ best_T[:3, :3].T + best_T[:3, 3] - dst,
                         axis=-1)
    m = err < threshold
    if m.sum() >= sample_size:
        best_T = umeyama(src[m], dst[m])
    return best_T


def align_trajectories(est_poses: np.ndarray, gt_poses: np.ndarray,
                       gt_trans: Optional[np.ndarray] = None,
                       map_file: Optional[str] = None) -> np.ndarray:
    """Reference trajectory_alignment (registration.py:65-110): GT camera
    centers (optionally pre-transformed by the dataset alignment), est
    trajectory sparsified by the mapping when it covers every movie
    frame, then RANSAC similarity alignment."""
    gt_centers = gt_poses[:, :3, 3]
    if gt_trans is not None:
        gt_centers = gt_centers @ gt_trans[:3, :3].T + gt_trans[:3, 3]
    if len(est_poses) > 1600 and map_file is not None:
        _, _, mapping = read_mapping(map_file)
        est_poses = sparse_trajectory(mapping, est_poses)
    return ransac_trajectory_alignment(est_poses[:, :3, 3], gt_centers)


# --------------------------------------------------------------------------
# crop volume (Open3D SelectionPolygonVolume json)
# --------------------------------------------------------------------------

def points_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """``matplotlib.path.Path(poly).contains_points(points)``: the polygon
    closed back to its first vertex, a +x ray from each point, its
    crossings counted even-odd with matplotlib's comparisons (an edge
    counts where its end y values straddle the point's, ``y >= ty`` on one
    side, and the ray meets it at or right of the point)."""
    tx, ty = points[:, 0], points[:, 1]
    inside = np.zeros(len(points), bool)
    verts = np.asarray(poly, np.float64)
    x0, y0 = verts[0]
    yflag0 = y0 >= ty
    for x1, y1 in np.concatenate([verts[1:], verts[:1]]):
        yflag1 = y1 >= ty
        cross = yflag0 != yflag1
        hit = ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1
        inside ^= cross & hit
        yflag0 = yflag1
        x0, y0 = x1, y1
    return inside


class SelectionVolume:
    """Points inside [axis_min, axis_max] along the orthogonal axis AND
    inside the bounding polygon projected on the other two axes."""

    def __init__(self, axis: str, axis_min: float, axis_max: float,
                 polygon: np.ndarray):
        self.axis = {"X": 0, "Y": 1, "Z": 2}[axis.upper()]
        self.axis_min, self.axis_max = axis_min, axis_max
        ij = [k for k in range(3) if k != self.axis]
        self.ij = ij
        self.poly = polygon[:, ij]

    @classmethod
    def from_json(cls, path: str) -> "SelectionVolume":
        with open(path) as f:
            d = json.load(f)
        return cls(d["orthogonal_axis"], d["axis_min"], d["axis_max"],
                   np.asarray(d["bounding_polygon"], float))

    def contains(self, points: np.ndarray) -> np.ndarray:
        a = points[:, self.axis]
        ok = (a >= self.axis_min) & (a <= self.axis_max)
        ok &= points_in_polygon(points[:, self.ij], self.poly)
        return ok

    def crop(self, points: np.ndarray) -> np.ndarray:
        return points[self.contains(points)]


# --------------------------------------------------------------------------
# downsampling
# --------------------------------------------------------------------------

def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Open3D voxel_down_sample semantics: one point per voxel, the MEAN
    of its members. Bins are anchored at the cloud's min bound (Open3D
    computes voxel indices relative to min_bound, not the origin —
    binning at the absolute origin shifts which points merge and with
    them the ICP/F-score numbers this feeds)."""
    # Open3D anchors voxel bins at min_bound - voxel/2 before flooring
    # (PointCloud::VoxelDownSample) — a plain min anchor merges different
    # groups, shifting ICP and the P/R/F1 this module must reproduce
    origin = points.min(axis=0) - voxel * 0.5
    keys = np.floor((points - origin) / voxel).astype(np.int64)
    # the JAX package's np.unique(keys, axis=0) and np.add.at, faster: one
    # int64 key per voxel in the same lexicographic order (keys are >= 0),
    # and per-coordinate bincounts, which sum each voxel's members in the
    # same order as add.at; the means are bit-identical (at 1.75M points
    # the row-wise unique took ~4 s a call on the card's host)
    span = keys.max(axis=0) + 1 if len(keys) else np.ones(3, np.int64)
    if float(span[0]) * float(span[1]) * float(span[2]) >= 2.0 ** 62:
        raise ValueError(f"voxel_downsample: {span.tolist()} voxels per "
                         "axis do not fit one int64 key")
    flat = (keys[:, 0] * span[1] + keys[:, 1]) * span[2] + keys[:, 2]
    _, inv, counts = np.unique(flat, return_inverse=True,
                               return_counts=True)
    sums = np.stack([np.bincount(inv, points[:, k], len(counts))
                     for k in range(3)], -1)
    return sums / counts[:, None]


def uniform_downsample(points: np.ndarray,
                       max_points: int = MAX_POINT_NUMBER) -> np.ndarray:
    """Every-k-th-point decimation, as o3d uniform_down_sample
    (registration.py:124-129)."""
    if len(points) > max_points:
        k = int(round(len(points) / float(max_points)))
        return points[::max(k, 1)]
    return points


# --------------------------------------------------------------------------
# ICP with scaling (o3d TransformationEstimationPointToPoint(True))
# --------------------------------------------------------------------------

def icp_similarity(src: np.ndarray, dst: np.ndarray, max_corr: float,
                   max_iter: int = 20,
                   init: Optional[np.ndarray] = None,
                   rel_tol: float = 1e-6) -> np.ndarray:
    from scipy.spatial import cKDTree
    T = np.eye(4) if init is None else init.copy()
    tree = cKDTree(dst)
    cur = src @ T[:3, :3].T + T[:3, 3]
    prev = np.inf
    for _ in range(max_iter):
        d, j = tree.query(cur, k=1, distance_upper_bound=max_corr,
                          workers=-1)
        m = np.isfinite(d)
        if m.sum() < 4:
            break
        delta = umeyama(cur[m], dst[j[m]])
        T = delta @ T
        cur = src @ T[:3, :3].T + T[:3, 3]
        err = float(d[m].mean())
        if abs(prev - err) < rel_tol * max(err, 1e-12):
            break
        prev = err
    return T


# --------------------------------------------------------------------------
# EvaluateHisto + plots
# --------------------------------------------------------------------------

def evaluate_histo(rec: np.ndarray, gt: np.ndarray, trans: np.ndarray,
                   volume: Optional[SelectionVolume], voxel: float,
                   threshold: float, out_dir: Optional[str] = None,
                   scene_name: str = "scene",
                   plot_stretch: float = 5.0) -> dict:
    """Reference EvaluateHisto (evaluation.py:60-215): transform + crop +
    voxel-downsample both clouds, bidirectional distances, P/R/F1 at τ,
    cumulative histograms; txt + plot outputs under out_dir."""
    from .geometry import nn_distances
    s = rec @ trans[:3, :3].T + trans[:3, 3]
    if volume is not None:
        s = volume.crop(s)
        gt = volume.crop(gt)
    s = voxel_downsample(s, voxel)
    t = voxel_downsample(gt, voxel)
    d1 = nn_distances(s, t)       # precision side (rec → gt)
    d2 = nn_distances(t, s)       # recall side (gt → rec)
    precision = float((d1 < threshold).mean()) if len(d1) else 0.0
    recall = float((d2 < threshold).mean()) if len(d2) else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)

    bins = np.arange(0, threshold * plot_stretch, threshold / 100)
    h1, edges1 = np.histogram(d1, bins)
    cum1 = np.cumsum(h1).astype(float) / max(len(d1), 1)
    h2, edges2 = np.histogram(d2, bins)
    cum2 = np.cumsum(h2).astype(float) / max(len(d2), 1)

    out = {"precision": precision, "recall": recall, "fscore": f1,
           "threshold": threshold,
           "edges_source": edges1, "cum_source": cum1,
           "edges_target": edges2, "cum_target": cum2,
           "n_source": int(len(s)), "n_target": int(len(t))}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        np.savetxt(os.path.join(out_dir, f"{scene_name}.recall.txt"), cum2)
        np.savetxt(os.path.join(out_dir, f"{scene_name}.precision.txt"),
                   cum1)
        np.savetxt(
            os.path.join(out_dir, f"{scene_name}.prf_tau_plotstr.txt"),
            np.array([precision, recall, f1, threshold, plot_stretch]))
        _plot_graph(scene_name, f1, threshold, edges1, cum1, edges2, cum2,
                    plot_stretch, out_dir)
    return out


def _plot_graph(scene, fscore_v, dist_threshold, edges_source, cum_source,
                edges_target, cum_target, plot_stretch, out_dir):
    """Cumulative precision/recall curves (reference plot.py), where
    matplotlib is installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"{scene}: matplotlib is not installed; the precision/recall "
              "plot was not drawn (its curves are in the .txt files)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(111)
    ax.plot(edges_source[1:], cum_source, c="tab:red",
            label="precision")
    ax.plot(edges_target[1:], cum_target, c="tab:blue",
            label="recall")
    ax.axvline(dist_threshold, c="gray", ls="--",
               label=f"τ = {dist_threshold:g}")
    ax.set_xlabel("distance")
    ax.set_ylabel("fraction")
    ax.set_title(f"{scene}  F1@τ = {fscore_v:.4f}")
    ax.set_xlim(0, dist_threshold * plot_stretch)
    ax.set_ylim(0, 1)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.savefig(os.path.join(
        out_dir, f"{scene}.precision_recall.png"), dpi=110,
        bbox_inches="tight")
    plt.close(fig)


# --------------------------------------------------------------------------
# full per-scene pipeline
# --------------------------------------------------------------------------

def mesh_eval_points(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Reference evaluation point set: vertices + face centers
    (run.py:94-101)."""
    if len(faces) == 0:
        return verts
    centers = verts[faces].mean(axis=1)
    return np.concatenate([verts, centers], axis=0)


def run_tnt_evaluation(ply_path: str, dataset_dir: str, traj_path: str,
                       out_dir: str,
                       scene: Optional[str] = None) -> dict:
    """The reference run_evaluation (run.py:58-207). ``dataset_dir`` must
    hold <scene>.ply (GT), <scene>_trans.txt, <scene>_COLMAP_SfM.log,
    <scene>.json (crop), optionally <scene>_mapping_reference.txt."""
    scene = scene or os.path.basename(os.path.normpath(dataset_dir))
    if scene not in SCENES_TAU:
        raise ValueError(f"unknown TnT scene {scene!r}")
    dtau = SCENES_TAU[scene]

    verts, faces, _ = read_mesh_ply(ply_path)
    rec = mesh_eval_points(verts, faces)
    gt, _, _ = read_point_cloud(os.path.join(dataset_dir, f"{scene}.ply"))
    gt_trans = np.loadtxt(os.path.join(dataset_dir, f"{scene}_trans.txt"))
    gt_traj = read_trajectory_log(
        os.path.join(dataset_dir, f"{scene}_COLMAP_SfM.log"))
    est_traj = read_trajectory_log(traj_path)
    volume = SelectionVolume.from_json(
        os.path.join(dataset_dir, f"{scene}.json"))
    # the reference hard-disables the mapping file (run.py:85)
    T0 = align_trajectories(est_traj, gt_traj, gt_trans, map_file=None)

    # three ICP refinement stages (run.py:155-160), each on crop+downsample
    # the cropped GT never changes across stages — crop the (tens of
    # millions of points) cloud once, not three times
    gt_c = volume.crop(gt)
    if len(gt_c) == 0:
        raise ValueError(
            "crop volume contains no GT points — check the crop json / "
            "GT alignment")

    def stage(T, voxel, corr, uniform=False):
        s = rec @ T[:3, :3].T + T[:3, 3]
        s = volume.crop(s)
        if len(s) == 0:
            raise ValueError(
                "aligned reconstruction has no points inside the crop "
                "volume — the initial trajectory alignment likely failed")
        if uniform:
            s, t = uniform_downsample(s), uniform_downsample(gt_c)
        else:
            s, t = voxel_downsample(s, voxel), voxel_downsample(gt_c, voxel)
        return icp_similarity(s, t, corr, max_iter=20) @ T

    T = stage(T0, dtau, dtau * 80)
    T = stage(T, dtau / 2.0, dtau * 20)
    T = stage(T, 0.0, 2 * dtau, uniform=True)

    res = evaluate_histo(rec, gt, T, volume, dtau / 2.0, dtau,
                         out_dir=out_dir, scene_name=scene)
    res["transform"] = T
    return res


# --------------------------------------------------------------------------
# simplified single-call scoring (kept for pre-aligned fixtures/tests)
# --------------------------------------------------------------------------

def evaluate_scene(mesh_path: str, gt_points_path: str,
                   threshold: float, *, n_samples: int = 1_000_000,
                   init_transform: Optional[np.ndarray] = None,
                   icp_refine: bool = True) -> dict:
    verts, faces, _ = read_mesh_ply(mesh_path)
    rec = sample_mesh_points(verts, faces, n_samples)
    gt, _, _ = read_point_cloud(gt_points_path)

    if init_transform is not None:
        rec = rec @ init_transform[:3, :3].T + init_transform[:3, 3]

    dsize = threshold  # reference downsamples at the threshold scale
    rec_d = voxel_downsample(rec, dsize)
    gt_d = voxel_downsample(gt, dsize)

    if icp_refine:
        T = icp_point_to_point(rec_d, gt_d, max_corr_dist=threshold * 10)
        rec_d = rec_d @ T[:3, :3].T + T[:3, 3]

    out = fscore(rec_d, gt_d, threshold)
    out["threshold"] = threshold
    return out
