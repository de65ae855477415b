"""The port's meshing (ops/tsdf.py, ops/marching.py, render/extract.py,
utils/render_paths.py, the mesh PLY codec) against the JAX package's, on
the inputs of tests/test_mesh.py and tests/test_marching_bound.py.

- ``integrate``: six analytic sphere depth maps; tsdf and colour within
  1e-5, weights exact. (XLA's CPU dot rounds the view transform in
  another order than torch's, which moves voxels by ~1e-6.)
- ``marching_tets``: sphere, torus and thin torus, float64 and float32,
  with and without a mask: the same vertices (within 1e-6) in the same
  order and the same faces, index for index.
- ``largest_clusters``: identical.
- ``GaussianExtractor`` via test_mesh.py's ``_fake_extractor`` (maps
  given, no render): unbounded, monolithic and block-wise, faces identical
  and vertices and colours within 1e-5; bounded, the same mesh up to the
  order of a few vertices whose welding key moves with that ~1e-6: the
  nearest-vertex map is one to one within 1e-5 and carries the JAX faces
  onto the port's face for face; colours, read from the voxel a vertex
  falls in, agree on all but < 0.5% of vertices.
- ``render_paths``: within 1e-9.
"""

import math

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import gs2d_torch.ops.marching as tm
import gs2d_torch.utils.render_paths as trp
import gs2d_tpu.ops.marching as jm
import gs2d_tpu.utils.render_paths as jrp
from gs2d_torch.ops.tsdf import integrate as t_integrate
from gs2d_torch.ops.tsdf import make_volume as t_make_volume
from gs2d_torch.render.extract import GaussianExtractor as TExtractor
from gs2d_torch.scene.cameras import CameraData as TCameraData
from gs2d_torch.scene.cameras import make_camera as t_make_camera
from gs2d_torch.scene.ply import read_mesh_ply as t_read_mesh
from gs2d_torch.scene.ply import write_mesh_ply as t_write_mesh
from gs2d_tpu.ops.tsdf import integrate as j_integrate
from gs2d_tpu.ops.tsdf import make_volume as j_make_volume
from gs2d_tpu.scene.cameras import CameraData as JCameraData
from gs2d_tpu.scene.cameras import make_camera as j_make_camera
from gs2d_tpu.scene.ply import read_mesh_ply as j_read_mesh
from gs2d_tpu.scene.ply import write_mesh_ply as j_write_mesh

from .test_mesh import _fake_extractor, _sphere_view_maps
from .test_torch_common import one_torch_thread  # noqa: F401

EYES = ([2.5, 0, 0], [-2.5, 0, 0], [0, 2.5, 0], [0, -2.5, 0], [0, 0, 2.5],
        [0, 0, -2.5])


def _grid(n):
    xs = np.linspace(-1, 1, n)
    return np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1), \
        xs[1] - xs[0]


def _sdf(case, n=48):
    g, vox = _grid(n)
    if case == "sphere":
        return np.linalg.norm(g, axis=-1) - 0.6, vox
    if case == "two_spheres":
        return np.minimum(
            np.linalg.norm(g - np.array([0.45, 0, 0]), axis=-1) - 0.3,
            np.linalg.norm(g + np.array([0.45, 0, 0]), axis=-1) - 0.15), vox
    r = 2.5 * vox if case == "thin_torus" else 0.25
    q = np.stack([np.linalg.norm(g[..., :2], axis=-1) - 0.6, g[..., 2]], -1)
    return np.linalg.norm(q, axis=-1) - r, vox


def _port_camera(jcam):
    """The port's camera with the JAX camera's exact matrices."""
    wv = np.asarray(jcam.world_view, np.float64)
    return t_make_camera(wv[:3, :3], wv[3, :3], jcam.fovx, jcam.fovy,
                         jcam.width, jcam.height, device="cpu")


def _port_extractor(jx):
    ex = TExtractor.__new__(TExtractor)
    ex.device = torch.device("cpu")
    ex.clean()
    for cd, d, a, c in zip(jx.viewpoints, jx.depthmaps, jx.alphamaps,
                           jx.rgbmaps):
        ex.viewpoints.append(TCameraData(camera=_port_camera(cd.camera)))
        ex.depthmaps.append(torch.from_numpy(d))
        ex.alphamaps.append(torch.from_numpy(a))
        ex.rgbmaps.append(torch.from_numpy(c))
    return ex


@pytest.mark.parametrize("voxel", [0.05, 0.025])
def test_integrate_matches_jax(voxel):
    import jax.numpy as jnp
    jv = j_make_volume(np.zeros(3), 0.9, voxel)
    tv = t_make_volume(np.zeros(3), 0.9, voxel, device="cpu")
    rgb = np.random.default_rng(0).random((3, 96, 96)).astype(np.float32)
    for eye in EYES:
        cam, depth, _ = _sphere_view_maps(eye)
        f = (96 / 2) / math.tan(math.radians(40) / 2)
        jv = j_integrate(jv, jnp.asarray(depth), jnp.asarray(rgb),
                         cam.world_view, f, f, 96, 96, 0.1, 3.0)
        t_integrate(tv, torch.from_numpy(depth), torch.from_numpy(rgb),
                    _port_camera(cam).world_view, f, f, 96, 96, 0.1, 3.0,
                    slab_voxels=5000)
    assert tv.voxel_size == jv.voxel_size
    np.testing.assert_array_equal(tv.origin.numpy(), np.asarray(jv.origin))
    np.testing.assert_array_equal(tv.weight.numpy(), np.asarray(jv.weight))
    assert float(tv.weight.max()) >= 3
    np.testing.assert_allclose(tv.tsdf.numpy(), np.asarray(jv.tsdf),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.color.numpy(), np.asarray(jv.color),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["sphere", "torus", "thin_torus",
                                  "two_spheres"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("masked", [False, True])
def test_marching_tets_matches_jax(case, dtype, masked):
    sdf, vox = _sdf(case, 64 if "torus" in case else 48)
    sdf = sdf.astype(dtype)
    mask = np.random.default_rng(1).random(sdf.shape) > 0.01 \
        if masked else None
    origin = np.array([-1.0, -1.0, -1.0])
    vj, fj = jm.marching_tets(sdf, origin=origin, voxel_size=vox, mask=mask)
    vt, ft = tm.marching_tets(
        torch.from_numpy(sdf), origin=origin, voxel_size=vox,
        mask=None if mask is None else torch.from_numpy(mask),
        slab_cubes=20_000)
    assert len(fj) > 1000 and vt.dtype == torch.float32
    np.testing.assert_array_equal(ft.numpy(), fj)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=1e-6)


def test_largest_clusters_matches_jax():
    sdf, _ = _sdf("two_spheres", 40)
    verts, faces = jm.marching_tets(sdf)
    for k, floor in ((1, 0), (2, 0), (5, 50), (1, 10 ** 6)):
        a = jm.largest_clusters(verts, faces, num_clusters=k, min_faces=floor)
        b = tm.largest_clusters(verts, faces, num_clusters=k,
                                min_faces=floor)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [3, 0, 0],
                      [4, 0, 0], [4, 1, 0], [5, 0, 0]], np.float64)
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 1], [4, 5, 6], [4, 7, 3]])
    for x, y in zip(jm.largest_clusters(verts, faces),
                    tm.largest_clusters(verts, faces)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("block", [48, 20])
def test_extractor_unbounded_matches_jax(block):
    jx = _fake_extractor()
    ex = _port_extractor(jx)
    vj, fj, cj = jx.extract_mesh_unbounded(resolution=48, block_size=block)
    vt, ft, ct = ex.extract_mesh_unbounded(resolution=48, block_size=block)
    assert (ex.center == jx.center).all() and ex.radius == jx.radius
    assert len(fj) > 200
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("voxel", [0.06, 0.045])
def test_extractor_bounded_matches_jax(voxel):
    jx = _fake_extractor()
    ex = _port_extractor(jx)
    vj, fj, cj = jx.extract_mesh_bounded(voxel_size=voxel, sdf_trunc=0.1,
                                         depth_trunc=3.0)
    vt, ft, ct = ex.extract_mesh_bounded(voxel_size=voxel, sdf_trunc=0.1,
                                         depth_trunc=3.0)
    assert len(fj) > 1000 and vt.shape == vj.shape and ft.shape == fj.shape
    dist, to_t = cKDTree(vt).query(vj)
    assert dist.max() < 1e-5
    assert len(np.unique(to_t)) == len(vj)            # one to one
    moved = (to_t != np.arange(len(vj))).sum()
    assert moved < 0.01 * len(vj)
    assert {tuple(f) for f in np.sort(to_t[fj], 1).tolist()} == \
        {tuple(f) for f in np.sort(ft, 1).tolist()}
    # a colour is the voxel a vertex truncates into: the ~1e-6 moves a
    # few vertices across a voxel face
    off = np.abs(ct[to_t] - cj).max(1) > 1e-5
    assert off.mean() < 0.005, off.mean()


def _ring(make_camera, data_cls, n=12, **kw):
    cams = []
    for i in range(n):
        th = 2 * math.pi * i / n
        pos = np.array([4 * math.cos(th), 4 * math.sin(th), 1.0 + 0.1 * i])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 0, 1]), fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        T = -R.T @ pos
        cams.append(data_cls(camera=make_camera(
            R, T, math.radians(60), math.radians(45), 65, 49, **kw)))
    return cams


def test_render_paths_match_jax():
    jcams = _ring(j_make_camera, JCameraData)
    tcams = _ring(t_make_camera, TCameraData, device="cpu")
    c2ws = np.array([np.linalg.inv(np.asarray(cd.camera.world_view.T))
                     for cd in jcams])
    poses = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
    np.testing.assert_allclose(trp.focus_point_fn(poses),
                               jrp.focus_point_fn(poses), atol=1e-9)
    (pa, ta), (pb, tb) = (jrp.transform_poses_pca(poses),
                          trp.transform_poses_pca(poses))
    np.testing.assert_allclose(pb, pa, atol=1e-9)
    np.testing.assert_allclose(tb, ta, atol=1e-9)
    np.testing.assert_allclose(trp.generate_ellipse_path(pa, 30, 0.5, 0.2),
                               jrp.generate_ellipse_path(pa, 30, 0.5, 0.2),
                               atol=1e-9)
    ja, tb_ = jrp.generate_path(jcams, 20), trp.generate_path(tcams, 20)
    assert len(ja) == len(tb_) == 20
    for a, b in zip(ja, tb_):
        assert (a.width, a.height, a.fovx, a.fovy) == \
            (b.width, b.height, b.fovx, b.fovy) == (a.width, 48, a.fovx,
                                                    a.fovy)
        np.testing.assert_allclose(b.world_view.numpy(),
                                   np.asarray(a.world_view), atol=1e-6)


@pytest.mark.parametrize("writer,reader", [(j_write_mesh, t_read_mesh),
                                           (t_write_mesh, j_read_mesh)])
@pytest.mark.parametrize("colored", [False, True])
def test_mesh_ply_both_ways(tmp_path, writer, reader, colored):
    sdf, _ = _sdf("sphere", 24)
    verts, faces = jm.marching_tets(sdf)
    colors = np.random.default_rng(0).random((len(verts), 3)).astype(
        np.float32) if colored else None
    writer(str(tmp_path / "m.ply"), verts, faces, colors)
    v2, f2, c2 = reader(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(v2, verts)
    np.testing.assert_array_equal(f2, faces)
    if colored:
        assert np.abs(c2 - colors).max() <= 0.5 / 255 + 1e-6
    else:
        assert c2 is None
