"""The port's geometry evaluation (gs2d_torch/eval/{geometry,dtu,tnt}.py)
against the JAX package's and against the libraries it replaces, on the
CPU.

- Where the port's code is a copy (sampling, thinning, voxel downsample,
  ``SelectionVolume``, the DTU cull's kept faces): exactly equal.
- Chamfer, F-score, ICP and the similarity transforms: within 1e-9
  relative (the same NumPy/SciPy arithmetic; the bar leaves room for a
  BLAS that orders a sum otherwise).
- The cv2 replacements: ``decompose_projection`` within 1e-6 of
  ``cv2.decomposeProjectionMatrix`` (K, R, the centre dehomogenised); the
  ellipse footprint and the dilation equal to cv2's for radii 1-30; the
  gray mask read equal to ``cv2.imread(IMREAD_GRAYSCALE)``.
- The crossing test equal to matplotlib's ``contains_points`` on seeded
  polygons and points, points on edges and vertices excluded.
- The fixtures of tests/test_dtu_harness.py and tests/test_tnt_protocol.py
  through both packages, the full TnT pipeline recovering the alignment.
"""

import os

import cv2
import numpy as np
import pytest
from matplotlib.path import Path
from scipy.spatial.transform import Rotation

import gs2d_torch.eval.dtu as t_dtu
import gs2d_torch.eval.geometry as t_geo
import gs2d_torch.eval.tnt as t_tnt
import gs2d_tpu.eval.dtu as j_dtu
import gs2d_tpu.eval.geometry as j_geo
import gs2d_tpu.eval.tnt as j_tnt
from gs2d_torch.scene.images import encode_png

from . import test_dtu_harness as dtu_fx
from . import test_tnt_protocol as tnt_fx

REL = 1e-9


def _close(a, b, rel=REL):
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(
        1.0, float(np.max(np.abs(b), initial=0.0))))


def _blob(seed, n=3000):
    rng = np.random.default_rng(seed)
    return rng.random((n, 3)) * np.array([1.0, 0.5, 0.25])


def test_geometry_copies_are_exact():
    verts, faces = tnt_fx._sphere_mesh(nt=40, np_=20)
    for seed in (0, 3):
        np.testing.assert_array_equal(
            t_geo.sample_mesh_points(verts, faces, 5000, seed),
            j_geo.sample_mesh_points(verts, faces, 5000, seed))
    pts = _blob(1, 20000) * 0.3
    np.testing.assert_array_equal(t_geo.thin_points(pts, 0.02),
                                  j_geo.thin_points(pts, 0.02))
    with pytest.raises(ValueError):
        t_geo.sample_mesh_points(np.zeros((3, 3)), np.array([[0, 1, 2]]), 5)


def test_chamfer_fscore_icp_match_jax():
    a, b = _blob(2), _blob(3) + 0.01
    for md in (np.inf, 0.05):
        _close(t_geo.chamfer_distance(a, b, md),
               j_geo.chamfer_distance(a, b, md))
    for tau in (0.01, 0.05):
        got, ref = t_geo.fscore(a, b, tau), j_geo.fscore(a, b, tau)
        assert got.keys() == ref.keys()
        _close([got[k] for k in ref], [ref[k] for k in ref])
    R = Rotation.from_euler("xyz", [0.05, -0.08, 0.1]).as_matrix()
    dst = a @ R.T + np.array([0.03, -0.02, 0.01])
    T = t_geo.icp_point_to_point(a, dst, max_corr_dist=0.3)
    _close(T, j_geo.icp_point_to_point(a, dst, max_corr_dist=0.3))
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-3)


# --- DTU: the cv2 replacements -----------------------------------------------

def test_decompose_projection_matches_cv2():
    rng = np.random.default_rng(0)
    for i in range(40):
        K = np.array([[rng.uniform(200, 2000), rng.normal() * 3,
                       rng.uniform(0, 800)],
                      [0, rng.uniform(200, 2000), rng.uniform(0, 600)],
                      [0, 0, 1.0]])
        R = Rotation.random(random_state=i).as_matrix()
        t = rng.normal(size=(3, 1)) * 3
        # the IDR layout's positive scale, and a negative one
        P = K @ np.hstack([R, t]) * (rng.uniform(0.1, 5) * (-1) ** i)
        k_cv, r_cv, c_cv = cv2.decomposeProjectionMatrix(P)[:3]
        k, r, c = t_dtu.decompose_projection(P)
        np.testing.assert_allclose(k, k_cv, rtol=1e-6, atol=1e-6 * np.abs(
            k_cv).max())
        np.testing.assert_allclose(r, r_cv, rtol=0, atol=1e-6)
        np.testing.assert_allclose(c[:3] / c[3], c_cv[:3] / c_cv[3],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("radius", range(1, 31))
def test_ellipse_dilation_matches_cv2(radius):
    side = 2 * radius + 1
    ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (side, side))
    fp = t_dtu.ellipse_footprint(side, side)
    np.testing.assert_array_equal(fp, ref)
    # seeded sparse mask with foreground on the border (outside counts as
    # background) and one wide blob
    rng = np.random.default_rng(radius)
    mask = (rng.random((57, 83)) > 0.996).astype(np.uint8)
    mask[0, 5] = mask[56, 82] = mask[30, 0] = 1
    mask[20:26, 40:49] = 1
    got = t_dtu.dilate(mask, fp, "cpu")
    np.testing.assert_array_equal(got, cv2.dilate(mask, ref) > 0)


def test_ellipse_footprint_non_square_matches_cv2():
    for w, h in ((1, 1), (5, 3), (3, 7), (49, 49), (10, 6), (2, 2)):
        np.testing.assert_array_equal(
            t_dtu.ellipse_footprint(w, h),
            cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (w, h)))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_mask_gray_matches_cv2_imread(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (41, 67) if channels == 1 else (41, 67, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if channels >= 3:
        img[0, 0, :3] = (1, 0, 0)          # cv2 reads it as 0
        img[0, 1, :3] = (9, 9, 9)          # gray pixels pass through
    path = str(tmp_path / "m.png")
    encode_png(path, img)
    got = t_dtu.read_mask_gray(path)
    np.testing.assert_array_equal(got, cv2.imread(path,
                                                  cv2.IMREAD_GRAYSCALE))
    if channels >= 3:
        assert got[0, 0] == 0


# --- DTU: the harness fixtures ----------------------------------------------

def _dtu_setup(tmp_path, with_masks):
    ov, of = dtu_fx._cube([0, 0, 0], 0.3)
    fv, ff = dtu_fx._cube([0.9, 0.5, 0.3], 0.12)
    verts = np.concatenate([ov, fv])
    faces = np.concatenate([of, ff + len(ov)])
    gt = j_geo.sample_mesh_points(ov, of, 20000) * dtu_fx.SCALE + \
        dtu_fx.OFFSET
    official = str(tmp_path / "official")
    if not os.path.exists(official):
        dtu_fx._write_official(official, gt)
    scan = dtu_fx._write_fixture(
        str(tmp_path / ("masked" if with_masks else "unmasked")), with_masks)
    mesh = str(tmp_path / "mesh.ply")
    from gs2d_torch.scene.ply import write_mesh_ply
    write_mesh_ply(mesh, verts, faces)
    return mesh, official, scan


def test_dtu_cull_and_chamfer_match_jax(tmp_path):
    """test_dtu_harness.py's fixture: the port's cull keeps the same faces
    as the JAX cull (OpenCV there), and its chamfer equals the JAX one;
    culling removes the floater."""
    res = {}
    for masks in (True, False):
        mesh, official, scan = _dtu_setup(tmp_path, masks)
        from gs2d_torch.scene.ply import read_mesh_ply
        verts, faces, _ = read_mesh_ply(mesh)
        tc = t_dtu.cull_mesh_for_scan(verts, faces, scan, device="cpu")
        jc = j_dtu.cull_mesh_for_scan(verts, faces, scan)
        if masks:
            np.testing.assert_array_equal(tc[1], jc[1])
            np.testing.assert_array_equal(tc[0], jc[0])
            assert len(tc[1]) < len(faces)
        else:
            assert tc is None and jc is None
        kw = dict(obs_mask_path=os.path.join(official, "ObsMask",
                                             "ObsMask24_10.mat"),
                  n_samples=60_000, scan_dir=scan)
        gt = os.path.join(official, "Points", "stl", "stl024_total.ply")
        got = t_dtu.evaluate_scan(mesh, gt, device="cpu", **kw)
        ref = j_dtu.evaluate_scan(mesh, gt, **kw)
        assert got.keys() == ref.keys()
        _close([got[k] for k in ref], [ref[k] for k in ref])
        res[masks] = got
    assert res[True]["overall"] < res[False]["overall"] * 0.8
    assert res[True]["overall"] < 0.2
    assert res[False]["mean_d2s"] > res[True]["mean_d2s"] * 2


def test_dtu_cull_keeps_out_of_view_geometry(tmp_path):
    scan = dtu_fx._write_fixture(str(tmp_path / "d"), with_masks=True)
    bv, bf = dtu_fx._cube([0, 0, 9.0], 0.1)
    _, faces = t_dtu.cull_mesh_for_scan(bv, bf, scan, device="cpu")
    assert len(faces) == len(bf)


def test_dtu_scan_mesh_without_obsmask_matches_jax(tmp_path):
    verts, faces = tnt_fx._sphere_mesh(nt=30, np_=15, r=5.0)
    gt = j_geo.sample_mesh_points(verts, faces, 4000, seed=9) + 0.05
    path = str(tmp_path / "gt.ply")
    from gs2d_torch.scene.ply import write_point_cloud
    write_point_cloud(path, gt, np.full_like(gt, 0.5))
    kw = dict(density=0.2, max_dist=20.0, n_samples=20_000)
    got = t_dtu.evaluate_scan_mesh(verts, faces, path, **kw)
    ref = j_dtu.evaluate_scan_mesh(verts, faces, path, **kw)
    _close([got[k] for k in ref], [ref[k] for k in ref])


# --- TnT ---------------------------------------------------------------------

def test_tnt_small_pieces_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3))
    dst = tnt_fx._apply(tnt_fx._T_true(), src)
    _close(t_tnt.umeyama(src, dst), j_tnt.umeyama(src, dst))
    np.testing.assert_allclose(t_tnt.umeyama(src, dst), tnt_fx._T_true(),
                               atol=1e-9)
    poses = np.tile(np.eye(4), (7, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(7, 3))
    t_tnt.write_trajectory_log(str(tmp_path / "t.log"), poses)
    j_tnt.write_trajectory_log(str(tmp_path / "j.log"), poses)
    assert (tmp_path / "t.log").read_bytes() == \
        (tmp_path / "j.log").read_bytes()
    np.testing.assert_array_equal(
        t_tnt.read_trajectory_log(str(tmp_path / "t.log")),
        j_tnt.read_trajectory_log(str(tmp_path / "t.log")))
    (tmp_path / "m.txt").write_text("3\n10\n1 2\n2 5\n3 9\n")
    _, _, mapping = t_tnt.read_mapping(str(tmp_path / "m.txt"))
    movie = np.arange(10)[:, None, None] * np.ones((10, 4, 4))
    np.testing.assert_array_equal(t_tnt.sparse_trajectory(mapping, movie),
                                  j_tnt.sparse_trajectory(mapping, movie))
    pts = rng.normal(size=(20000, 3)) * 0.7
    np.testing.assert_array_equal(t_tnt.voxel_downsample(pts, 0.1),
                                  j_tnt.voxel_downsample(pts, 0.1))
    np.testing.assert_array_equal(t_tnt.uniform_downsample(pts, 3000),
                                  j_tnt.uniform_downsample(pts, 3000))
    np.testing.assert_array_equal(t_tnt.mesh_eval_points(*tnt_fx._sphere_mesh(
        12, 8)), j_tnt.mesh_eval_points(*tnt_fx._sphere_mesh(12, 8)))


def _polygon(rng, kind):
    n = int(rng.integers(3, 14))
    if kind == "star":
        ang = np.sort(rng.random(n)) * 2 * np.pi
        rad = rng.uniform(0.2, 1.5, n)
        return np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    return rng.normal(size=(n, 2))                 # self-intersecting


def _on_boundary(pts, poly, eps=1e-9):
    """Points within eps of an edge of the closed polygon."""
    near = np.zeros(len(pts), bool)
    for a, b in zip(poly, np.roll(poly, -1, 0)):
        ab = b - a
        t = np.clip(((pts - a) @ ab) / max(ab @ ab, 1e-300), 0, 1)
        near |= np.linalg.norm(pts - (a + t[:, None] * ab), axis=1) < eps
    return near


@pytest.mark.parametrize("kind", ["star", "random"])
def test_crossing_test_matches_matplotlib(kind):
    rng = np.random.default_rng(0 if kind == "star" else 1)
    for _ in range(20):
        poly = _polygon(rng, kind)
        pts = rng.uniform(-2, 2, (4000, 2))
        # vertices and edge midpoints, then excluded as on the boundary
        pts = np.concatenate([pts, poly, (poly + np.roll(poly, -1, 0)) / 2])
        keep = ~_on_boundary(pts, poly)
        assert keep.sum() >= 4000 - 5
        got = t_tnt.points_in_polygon(pts, poly)
        ref = Path(poly).contains_points(pts)
        np.testing.assert_array_equal(got[keep], ref[keep])


def test_selection_volume_matches_jax():
    rng = np.random.default_rng(4)
    poly = np.concatenate([_polygon(rng, "star"), np.zeros((0, 2))])
    poly3 = np.insert(poly, 1, 0.0, axis=1)        # Y is the axis
    vt = t_tnt.SelectionVolume("Y", -0.5, 0.7, poly3)
    vj = j_tnt.SelectionVolume("Y", -0.5, 0.7, poly3)
    pts = rng.uniform(-2, 2, (20000, 3))
    np.testing.assert_array_equal(vt.contains(pts), vj.contains(pts))
    np.testing.assert_array_equal(vt.crop(pts), vj.crop(pts))
    sq = t_tnt.SelectionVolume("Z", -1.0, 1.0, np.array(
        [[-2.0, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]]))
    np.testing.assert_array_equal(
        sq.contains(np.array([[0, 0, 0], [0, 0, 2.0], [3.0, 0, 0],
                              [1.9, 1.9, 0.9]])), [True, False, False, True])


@pytest.fixture(scope="module")
def tnt_run(tmp_path_factory):
    """test_tnt_protocol.py's Courthouse fixture through both packages."""
    tmp = tmp_path_factory.mktemp("tnt")
    d, traj = tnt_fx._write_fixture(tmp)
    Tinv = np.linalg.inv(tnt_fx._T_true())
    sv, sf = tnt_fx._sphere_mesh(nt=240, np_=120)
    fv, ff = tnt_fx._sphere_mesh(nt=48, np_=24, r=0.5, center=(4.0, 0, 0))
    verts = np.concatenate([tnt_fx._apply(Tinv, sv), tnt_fx._apply(Tinv, fv)])
    faces = np.concatenate([sf, ff + len(sv)])
    mesh = str(tmp / "rec.ply")
    from gs2d_torch.scene.ply import write_mesh_ply
    write_mesh_ply(mesh, verts, faces)
    got = t_tnt.run_tnt_evaluation(mesh, d, traj, str(tmp / "t"),
                                   scene="Courthouse")
    ref = j_tnt.run_tnt_evaluation(mesh, d, traj, str(tmp / "j"),
                                   scene="Courthouse")
    return tmp, d, verts, faces, got, ref


def test_tnt_pipeline_matches_jax_and_recovers_alignment(tnt_run):
    tmp, d, verts, faces, got, ref = tnt_run
    _close(got["transform"], ref["transform"])
    for k in ("precision", "recall", "fscore", "threshold"):
        _close(got[k], ref[k])
    for k in ("n_source", "n_target"):
        assert got[k] == ref[k]
    for k in ("cum_source", "cum_target", "edges_source", "edges_target"):
        _close(got[k], ref[k])
    Tinv = np.linalg.inv(tnt_fx._T_true())
    pts = np.random.default_rng(5).normal(size=(100, 3))
    err = np.linalg.norm(tnt_fx._apply(got["transform"],
                                       tnt_fx._apply(Tinv, pts)) - pts, axis=1)
    assert err.max() < 0.03
    assert min(got["precision"], got["recall"], got["fscore"]) > 0.97
    for fn in ("Courthouse.precision.txt", "Courthouse.recall.txt",
               "Courthouse.prf_tau_plotstr.txt",
               "Courthouse.precision_recall.png"):
        assert os.path.exists(tmp / "t" / fn), fn
    for fn in ("Courthouse.precision.txt", "Courthouse.recall.txt"):
        _close(np.loadtxt(tmp / "t" / fn), np.loadtxt(tmp / "j" / fn))
    # without the crop volume the floater hurts precision
    rec = t_tnt.mesh_eval_points(verts, faces)
    from gs2d_torch.scene.ply import read_point_cloud
    gt, _, _ = read_point_cloud(os.path.join(d, "Courthouse.ply"))
    nocrop = t_tnt.evaluate_histo(rec, gt, got["transform"], None, 0.0125,
                                  0.025)
    assert nocrop["precision"] < got["precision"] - 0.02


def test_tnt_histo_without_matplotlib(tnt_run, monkeypatch, capsys):
    """No matplotlib (as on the card's machine): one line says the plot
    was not drawn; the curves and the numbers are written as before."""
    import sys
    tmp, d, verts, faces, got, _ = tnt_run
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rec = t_tnt.mesh_eval_points(verts, faces)
    from gs2d_torch.scene.ply import read_point_cloud
    gt, _, _ = read_point_cloud(os.path.join(d, "Courthouse.ply"))
    vol = t_tnt.SelectionVolume.from_json(os.path.join(d, "Courthouse.json"))
    out = tmp / "no_mpl"
    res = t_tnt.evaluate_histo(rec, gt, got["transform"], vol, 0.0125, 0.025,
                               out_dir=str(out), scene_name="Courthouse")
    assert res["fscore"] == got["fscore"]
    assert "plot was not drawn" in capsys.readouterr().out
    assert not (out / "Courthouse.precision_recall.png").exists()
    for fn in ("Courthouse.precision.txt", "Courthouse.recall.txt",
               "Courthouse.prf_tau_plotstr.txt"):
        assert (out / fn).exists()
