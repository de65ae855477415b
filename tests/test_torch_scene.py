"""The port's scene layer (gs2d_torch/scene) against the JAX package's.

- COLMAP models: the port reads what the JAX writers write (binary) and
  the JAX readers read what the port writes, fields exact; both read the
  same text model alike.
- ``Scene`` on a tiny COLMAP scene with ``--eval`` (images 1700 px wide,
  so the default policy resizes them to 1600) and on a tiny Blender RGBA
  scene on a white and on a black background (and at ``-r 2``: RGBA
  composited, then resized), built like
  tests/test_scene_io.py:70-97: camera order, R, T and fovs exact;
  world_view and full_proj within 1e-6; cameras_extent within rtol 1e-6;
  cameras.json equal as JSON; the initial Gaussians within 1e-6; images
  and alpha masks exact — also through the resize, whose PIL bicubic the
  port reproduces bit for bit (100% of bytes equal).
- The Blender loader's random 100k init (``sh_to_rgb(rng.random/255)``)
  and its side-effect ``points3d.ply``; COLMAP's ``points3D.ply``.
"""

import json
import math
import os
import shutil

import numpy as np
import pytest
from PIL import Image

import gs2d_torch.scene.colmap as tc
import gs2d_tpu.scene.colmap as jc
from gs2d_torch.config import ModelParams as TModelParams
from gs2d_torch.scene.dataset import read_blender_scene as t_blender
from gs2d_torch.scene.scene import Scene as TScene
from gs2d_tpu.config import ModelParams as JModelParams
from gs2d_tpu.scene.dataset import read_blender_scene as j_blender
from gs2d_tpu.scene.scene import Scene as JScene

from .test_torch_common import one_torch_thread  # noqa: F401


def _model(tmp_path, n_img=3):
    rng = np.random.default_rng(0)
    cams = {1: (1, "PINHOLE", 640, 480, np.array([500.0, 510.0, 320, 240])),
            2: (2, "SIMPLE_PINHOLE", 320, 200, np.array([300.0, 160, 100]))}
    imgs = {}
    for i in range(1, n_img + 1):
        q = rng.normal(size=4)
        imgs[i] = (i, q / np.linalg.norm(q) * np.sign(q[0]),
                   rng.normal(size=3), 1 + i % 2, f"im{i:02d}.png",
                   rng.normal(size=(i + 2, 2)), rng.integers(-1, 50, i + 2))
    xyz = rng.normal(size=(30, 3))
    rgb = rng.integers(0, 256, (30, 3)).astype(np.uint8)
    return cams, imgs, xyz, rgb


@pytest.mark.parametrize("writer,reader", [(jc, tc), (tc, jc)])
def test_colmap_binary_both_ways(tmp_path, writer, reader):
    cams, imgs, xyz, rgb = _model(tmp_path)
    writer.write_cameras_binary({k: writer.ColmapCamera(*v)
                                 for k, v in cams.items()},
                                str(tmp_path / "cameras.bin"))
    writer.write_images_binary({k: writer.ColmapImage(*v)
                                for k, v in imgs.items()},
                               str(tmp_path / "images.bin"))
    writer.write_points3d_binary(xyz, rgb, str(tmp_path / "points3D.bin"))
    c2 = reader.read_cameras_binary(str(tmp_path / "cameras.bin"))
    kw = {"poses_only": False} if reader is jc else {}
    i2 = reader.read_images_binary(str(tmp_path / "images.bin"), **kw)
    x2, r2, _ = reader.read_points3d_binary(str(tmp_path / "points3D.bin"))
    for k, (cid, model, w, h, params) in cams.items():
        assert (c2[k].id, c2[k].model, c2[k].width, c2[k].height) == \
            (cid, model, w, h)
        np.testing.assert_array_equal(c2[k].params, params)
    for k, (iid, q, t, cid, name, xys, ids) in imgs.items():
        assert (i2[k].id, i2[k].camera_id, i2[k].name) == (iid, cid, name)
        np.testing.assert_array_equal(i2[k].qvec, q)
        np.testing.assert_array_equal(i2[k].tvec, t)
        np.testing.assert_array_equal(i2[k].xys, xys)
        np.testing.assert_array_equal(i2[k].point3d_ids, ids)
    np.testing.assert_array_equal(x2, xyz)
    np.testing.assert_array_equal(r2, rgb)


def test_colmap_text_and_rotations(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# cameras\n1 PINHOLE 640 480 500 510 320 240\n"
        "2 SIMPLE_PINHOLE 320 200 300 160 100\n")
    (tmp_path / "images.txt").write_text(
        "# images\n"
        "1 0.9 0.1 0.2 0.3 0.5 0.5 0.5 1 a.png\n"
        "10.0 20.0 7 30.0 40.0 9\n"
        "2 1 0 0 0 1.5 1.5 1.5 2 b.png\n"
        "\n"
        "3 0.5 0.5 0.5 0.5 2.5 2.5 2.5 1 c.png\n"
        "50.0 60.0 11\n")
    (tmp_path / "points3D.txt").write_text(
        "# points\n1 0.1 0.2 0.3 10 20 30 0.5 1 2\n"
        "2 -1 -2 -3 255 0 7 0.25\n")
    for name in ("cameras", "images"):
        a = getattr(jc, f"read_{name}_text")(str(tmp_path / f"{name}.txt"))
        b = getattr(tc, f"read_{name}_text")(str(tmp_path / f"{name}.txt"))
        assert sorted(a) == sorted(b)
        for k in a:
            for f in vars(a[k]):
                np.testing.assert_array_equal(getattr(a[k], f),
                                              getattr(b[k], f))
    for x, y in zip(jc.read_points3d_text(str(tmp_path / "points3D.txt")),
                    tc.read_points3d_text(str(tmp_path / "points3D.txt"))):
        np.testing.assert_array_equal(x, y)
    R = jc.qvec2rotmat(np.array([0.9, 0.1, 0.2, 0.3]) / math.sqrt(0.95))
    np.testing.assert_array_equal(tc.qvec2rotmat(jc.rotmat2qvec(R)),
                                  jc.qvec2rotmat(jc.rotmat2qvec(R)))
    np.testing.assert_array_equal(tc.rotmat2qvec(R), jc.rotmat2qvec(R))


def _colmap_scene(root, n=9, size=(1700, 96), ext=".png"):
    """Seeded RGB PNGs, or JPEGs for ``ext=".JPG"`` (wider than 1600 px:
    the default policy resizes) and a binary model: PINHOLE, poses on a
    ring, 40 points."""
    rng = np.random.default_rng(1)
    (root / "images").mkdir(parents=True)
    model = root / "sparse" / "0"
    model.mkdir(parents=True)
    w, h = size
    jc.write_cameras_binary({1: jc.ColmapCamera(
        1, "PINHOLE", w, h, np.array([900.0, 880.0, w / 2, h / 2]))},
        str(model / "cameras.bin"))
    imgs = {}
    for i in range(n):
        th = 2 * math.pi * i / n
        c2w = np.eye(4)
        c2w[:3, 3] = [4 * math.sin(th), 0.3 * i, 4 * math.cos(th)]
        c2w[:3, :3] = jc.qvec2rotmat(np.array([math.cos(th / 2), 0,
                                               math.sin(th / 2), 0]))
        w2c = np.linalg.inv(c2w)
        name = f"v{(i * 5) % n:02d}{ext}"          # ids and names disagree
        imgs[i + 1] = jc.ColmapImage(i + 1, jc.rotmat2qvec(w2c[:3, :3]),
                                     w2c[:3, 3], 1, name, np.zeros((0, 2)),
                                     np.zeros(0, np.int64))
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)) \
            .save(root / "images" / name,
                  **({"format": "JPEG", "quality": 90} if ext == ".JPG"
                     else {}))
    jc.write_images_binary(imgs, str(model / "images.bin"))
    jc.write_points3d_binary(rng.normal(size=(40, 3)),
                             rng.integers(0, 256, (40, 3)).astype(np.uint8),
                             str(model / "points3D.bin"))


def _blender_scene(root, n_train=3, n_test=2, size=(64, 48), seed_pts=True):
    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(root / split, exist_ok=True)
        frames = []
        for i in range(n):
            img = (rng.random((size[1], size[0], 4)) * 255).astype(np.uint8)
            Image.fromarray(img, "RGBA").save(root / split / f"r_{i}.png")
            th = i * 0.3 + (0.15 if split == "test" else 0.0)
            c2w = np.eye(4)
            c2w[:3, 3] = [4 * math.sin(th), 0, 4 * math.cos(th)]
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    if seed_pts:
        from gs2d_tpu.scene.ply import write_point_cloud
        write_point_cloud(str(root / "points3d.ply"),
                          rng.normal(size=(50, 3)).astype(np.float32),
                          rng.random((50, 3)).astype(np.float32))


def _assert_scenes_equal(js, ts):
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-6)
    for jl, tl in ((js.get_train_cameras(), ts.get_train_cameras()),
                   (js.get_test_cameras(), ts.get_test_cameras())):
        assert [c.image_name for c in jl] == [c.image_name for c in tl]
        for a, b in zip(jl, tl):
            assert a.uid == b.uid
            np.testing.assert_array_equal(a.R, b.R)
            np.testing.assert_array_equal(a.T, b.T)
            ca, cb = a.camera, b.camera
            assert (ca.fovx, ca.fovy, ca.width, ca.height) == \
                (cb.fovx, cb.fovy, cb.width, cb.height)
            for f in ("world_view", "full_proj", "campos"):
                np.testing.assert_allclose(getattr(cb, f).numpy(),
                                           np.asarray(getattr(ca, f)),
                                           rtol=0, atol=1e-6)
            np.testing.assert_array_equal(b.image.numpy(), a.image)
            if a.alpha_mask is None:
                assert b.alpha_mask is None
            else:
                np.testing.assert_array_equal(b.alpha_mask.numpy(),
                                              a.alpha_mask)
    jg, tg = js.gaussians, ts.gaussians
    act = np.asarray(jg.active)
    assert int(act.sum()) == tg.params.xyz.shape[0]
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        np.testing.assert_allclose(getattr(tg.params, f).numpy(),
                                   np.asarray(getattr(jg.params, f))[act],
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert tg.active_sh_degree == int(jg.active_sh_degree)


@pytest.mark.parametrize("kind", ["colmap_eval", "colmap_jpeg",
                                  "blender_white", "blender_black",
                                  "blender_black_r2"])
def test_scene_matches_jax(tmp_path, kind):
    # one copy of the dataset each: the loaders write side files into it
    data = tmp_path / "data_j"
    if kind == "colmap_eval":
        _colmap_scene(data)
    elif kind == "colmap_jpeg":
        _colmap_scene(data, ext=".JPG")
    else:
        _blender_scene(data)
    shutil.copytree(data, tmp_path / "data_t")
    kw = dict(eval=True, sh_degree=2,
              white_background=kind == "blender_white",
              resolution=2 if kind.endswith("_r2") else -1)
    js = JScene(JModelParams(source_path=str(data),
                             model_path=str(tmp_path / "j"), **kw),
                capacity=64, seed=3)
    ts = TScene(TModelParams(source_path=str(tmp_path / "data_t"),
                             model_path=str(tmp_path / "t"), **kw), seed=3,
                device="cpu")
    _assert_scenes_equal(js, ts)
    if kind.startswith("colmap"):
        assert len(ts.get_test_cameras()) == 2     # llffhold 8 of 9
        assert ts.get_train_cameras()[0].image.shape == (3, 90, 1600)
        ply = os.path.join("sparse", "0", "points3D.ply")
        assert (tmp_path / "data_j" / ply).read_bytes() == \
            (tmp_path / "data_t" / ply).read_bytes()
    assert json.loads((tmp_path / "j" / "cameras.json").read_text()) == \
        json.loads((tmp_path / "t" / "cameras.json").read_text())
    assert (tmp_path / "j" / "input.ply").read_bytes() == \
        (tmp_path / "t" / "input.ply").read_bytes()


def test_loaded_iteration_matches_jax(tmp_path):
    """load_iteration=-1 finds the newest point_cloud/iteration_N."""
    from gs2d_tpu.models.io import save_ply
    data = tmp_path / "data"
    _blender_scene(data)
    kw = dict(source_path=str(data), model_path=str(tmp_path / "m"),
              sh_degree=1)
    js = JScene(JModelParams(**kw), capacity=64, seed=0)
    for it in (7, 30):
        save_ply(js.gaussians, str(tmp_path / "m" / "point_cloud"
                                   / f"iteration_{it}" / "point_cloud.ply"))
    j2 = JScene(JModelParams(**kw), load_iteration=-1, shuffle=False)
    t2 = TScene(TModelParams(**kw), load_iteration=-1, shuffle=False,
                device="cpu")
    assert t2.loaded_iter == j2.loaded_iter == 30
    _assert_scenes_equal(j2, t2)


def test_blender_random_init_and_side_files(tmp_path):
    """No points3d.ply: both loaders draw the same 100k-point init and
    write it; without --eval the test frames join the training set."""
    for sub, read in (("j", j_blender), ("t", t_blender)):
        _blender_scene(tmp_path / sub, seed_pts=False)
        info = read(str(tmp_path / sub), eval_split=False)
        assert len(info.train_cameras) == 5 and not info.test_cameras
    assert (tmp_path / "j" / "points3d.ply").read_bytes() == \
        (tmp_path / "t" / "points3d.ply").read_bytes()
    a = j_blender(str(tmp_path / "j"))
    b = t_blender(str(tmp_path / "t"))
    for x, y in zip(a.point_cloud, b.point_cloud):
        np.testing.assert_array_equal(x, y)
    assert a.nerf_normalization["radius"] == b.nerf_normalization["radius"]
    assert len(a.point_cloud[0]) == 100_000


@pytest.mark.parametrize("resolution", [1, 2, -1])
def test_load_image_jpeg_matches_jax(resolution):
    """The 1920x1080 4:2:0 fixture at -r 1, -r 2 and the default policy
    (brought to 1600 px wide): the port's decode → resize → float equals
    the JAX loader's PIL path bit for bit."""
    from gs2d_torch.scene.dataset import CameraInfo as TInfo
    from gs2d_torch.scene.dataset import load_image as t_load
    from gs2d_tpu.scene.dataset import CameraInfo as JInfo
    from gs2d_tpu.scene.dataset import load_image as j_load
    path = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg",
                        "view_1080p_420_q95.jpg")
    kw = dict(uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.6,
              image_path=path, image_name="v", width=1920, height=1080)
    ji, ja, jwh = j_load(JInfo(**kw), resolution)
    ti, ta, twh = t_load(TInfo(**kw), resolution, device="cpu")
    assert twh == jwh == {1: (1920, 1080), 2: (960, 540),
                          -1: (1600, 900)}[resolution]
    assert ja is None and ta is None
    assert ti.dtype == ji.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)


def test_load_image_gray_alpha_png_is_a_deliberate_departure(tmp_path):
    """A gray+alpha PNG: the port loads its gray channel as RGB (three
    equal channels, no alpha mask); the JAX loader passes the PNG's two
    channels on, gray and alpha, as a two-channel image. The gray values
    agree; the channel counts are the departure (ROADMAP queue 3)."""
    from gs2d_torch.scene.dataset import CameraInfo as TInfo
    from gs2d_torch.scene.dataset import load_image as t_load
    from gs2d_tpu.scene.dataset import CameraInfo as JInfo
    from gs2d_tpu.scene.dataset import load_image as j_load
    rng = np.random.default_rng(5)
    la = rng.integers(0, 256, (12, 20, 2), dtype=np.uint8)
    path = str(tmp_path / "la.png")
    Image.fromarray(la, "LA").save(path)
    kw = dict(uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.6,
              image_path=path, image_name="la", width=20, height=12)
    ji, ja, jwh = j_load(JInfo(**kw), 1)
    ti, ta, twh = t_load(TInfo(**kw), 1, device="cpu")
    assert twh == jwh == (20, 12)
    assert ja is None and ta is None
    assert ji.shape == (2, 12, 20) and ti.shape == (3, 12, 20)
    np.testing.assert_array_equal(ji[1], la[..., 1] / np.float32(255))
    for c in range(3):
        np.testing.assert_array_equal(ti[c], ji[0])
