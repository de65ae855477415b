"""Dataset readers: COLMAP scenes and Blender/NeRF-synthetic JSON scenes.

Counterpart of ``gs2d_tpu/scene/dataset.py`` (the reference's
``scene/dataset_readers.py:26-260``): the same SceneInfo structure, NeRF++
normalization (radius = 1.1 × max camera distance from the average
center), every-8th-image test split for COLMAP eval (llffhold), random
100k-point init in [-1.3, 1.3]³ for Blender scenes without a point cloud,
RGBA alpha-composited onto the background. Images (PNG, or JPEG as
Mip-NeRF 360 and Tanks and Temples ship them) are decoded and resized by
the port's own codecs (``images.py``, ``jpeg.py``), bit for bit as PIL
does it for the JAX package. One deviation: a gray+alpha PNG loads as its gray
channel repeated to RGB (the JAX loader passes its two channels on).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

from ..ops.sh import sh_to_rgb
from ..ops.transforms import focal2fov, fov2focal
from .colmap import (detect_model_dir, qvec2rotmat, read_cameras_binary,
                     read_cameras_text, read_images_binary, read_images_text,
                     read_points3d_binary, read_points3d_text)
from .images import decode_image, image_size, resize
from .ply import read_point_cloud, write_point_cloud


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray          # cam→world rotation (reference convention)
    T: np.ndarray          # world→cam translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int


@dataclasses.dataclass
class SceneInfo:
    point_cloud: tuple      # (points, colors, normals)
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    centers = []
    for cam in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    dist = np.linalg.norm(centers - avg, axis=1)
    radius = float(dist.max()) * 1.1
    return {"translate": -avg, "radius": radius if radius > 0 else 1.0}


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    model_dir = detect_model_dir(path)
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(model_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(model_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(model_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(model_dir, "images.txt"))

    infos = []
    for idx, key in enumerate(sorted(imgs.keys())):
        im = imgs[key]
        cam = cams[im.camera_id]
        R = np.transpose(qvec2rotmat(im.qvec))
        T = np.array(im.tvec)
        if cam.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[0], cam.height)
        elif cam.model == "PINHOLE":
            fovx = focal2fov(cam.params[0], cam.width)
            fovy = focal2fov(cam.params[1], cam.height)
        else:
            raise ValueError(
                f"unsupported camera model {cam.model}; undistort the scene "
                "first (PINHOLE/SIMPLE_PINHOLE only)")
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
            image_path=os.path.join(path, images_dir, im.name),
            image_name=os.path.splitext(im.name)[0],
            width=cam.width, height=cam.height))
    infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    ply_path = os.path.join(model_dir, "points3D.ply")
    if not os.path.exists(ply_path):
        if os.path.exists(os.path.join(model_dir, "points3D.bin")):
            xyz, rgb, _ = read_points3d_binary(
                os.path.join(model_dir, "points3D.bin"))
        else:
            xyz, rgb, _ = read_points3d_text(
                os.path.join(model_dir, "points3D.txt"))
        write_point_cloud(ply_path, xyz.astype(np.float32),
                          rgb.astype(np.float32) / 255.0)
    pcd = read_point_cloud(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


def _read_blender_cameras(path: str, transforms_file: str,
                          extension: str = ".png") -> List[CameraInfo]:
    with open(os.path.join(path, transforms_file)) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    infos = []
    for idx, frame in enumerate(meta["frames"]):
        fname = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1                      # OpenGL → COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]
        width, height = image_size(fname)
        fovy = focal2fov(fov2focal(fovx, width), height)
        infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
            image_path=fname,
            image_name=os.path.splitext(os.path.basename(fname))[0],
            width=width, height=height))
    return infos


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True,
                       extension: str = ".png") -> SceneInfo:
    train = _read_blender_cameras(path, "transforms_train.json", extension)
    test = _read_blender_cameras(path, "transforms_test.json", extension) \
        if os.path.exists(os.path.join(path, "transforms_test.json")) \
        else []
    if not eval_split:
        # reference readNerfSyntheticInfo: without --eval the test frames
        # JOIN the training set (and the NeRF++ normalization radius is
        # computed over the merged cameras)
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        n = 100_000
        rng = np.random.default_rng(0)
        xyz = (rng.random((n, 3)).astype(np.float32) * 2.6 - 1.3)
        # reference: shs = random/255; colors = SH2RGB(shs) ~= 0.5 + eps
        # (near-constant gray, not uniform random colors)
        rgb = sh_to_rgb(rng.random((n, 3)).astype(np.float32) / 255.0)
        write_point_cloud(ply_path, xyz, np.asarray(rgb, np.float32))
    pcd = read_point_cloud(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train,
                     test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    raise ValueError(f"could not recognize scene type for {path}")


def target_size(orig_w: int, orig_h: int, resolution_arg: int = -1,
                resolution_scale: float = 1.0):
    """The resolution policy of the reference's utils/camera_utils.py:
    19-49: -r 1/2/4/8 divides, another positive -r is a target width,
    and by default an image wider than 1600 px is brought to 1600. Target
    dims use round() like camera_utils, not truncation."""
    if resolution_arg in (1, 2, 4, 8):
        scale = resolution_scale * resolution_arg
    else:
        global_down = orig_w / 1600.0 if orig_w > 1600 else 1.0
        if resolution_arg > 0:
            global_down = orig_w / resolution_arg
        scale = global_down * resolution_scale
    return round(orig_w / scale), round(orig_h / scale)


def load_image(info: CameraInfo, resolution_arg: int = -1,
               resolution_scale: float = 1.0,
               white_background: bool = False, device="cuda"):
    """Resolution policy + RGBA handling → (image (3,H,W) f32, alpha
    (1,H,W) f32 or None, (W, H)). A JPEG's pixel stages run on
    ``device``; the rest on the host.

    Reference ordering preserved: RGBA frames are alpha-composited onto
    the background at FULL resolution and truncated to uint8 BEFORE the
    resize — resizing unassociated alpha first gives different silhouette
    pixels."""
    arr_full = decode_image(info.image_path, device)
    orig_h, orig_w = arr_full.shape[:2]
    w, h = target_size(orig_w, orig_h, resolution_arg, resolution_scale)
    if arr_full.ndim == 3 and arr_full.shape[-1] == 4:
        norm = arr_full.astype(np.float32) / 255.0
        bg = np.ones(3, np.float32) if white_background else \
            np.zeros(3, np.float32)
        comp = norm[..., :3] * norm[..., 3:4] + bg * (1 - norm[..., 3:4])
        rgb8 = (np.clip(comp, 0, 1) * 255).astype(np.uint8)
        a8 = arr_full[..., 3]
        if (w, h) != (orig_w, orig_h):
            rgb8 = resize(rgb8, w, h)
            a8 = resize(a8, w, h)
        rgb = rgb8.astype(np.float32) / 255.0
        alpha = (a8.astype(np.float32) / 255.0)[..., None]
        return rgb.transpose(2, 0, 1), alpha.transpose(2, 0, 1), (w, h)

    if arr_full.ndim == 3 and arr_full.shape[-1] == 2:
        arr_full = arr_full[..., 0]             # gray+alpha: the gray
    if (w, h) != (orig_w, orig_h):
        arr_full = resize(arr_full, w, h)
    arr = arr_full.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    return arr[..., :3].transpose(2, 0, 1), None, (w, h)
