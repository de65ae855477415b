"""Scene assembly: dataset detection, camera loading, save-path layout.

Counterpart of ``gs2d_tpu/scene/scene.py`` (the reference's
``scene/__init__.py:25-92``): COLMAP vs Blender autodetection, shuffled
camera lists, ``cameras_extent`` from NeRF++ normalization, the
``point_cloud/iteration_N/point_cloud.ply`` layout, ``input.ply`` and
``cameras.json``. There is no capacity: the Gaussians are tensors of the
live rows on ``device``. Images stay CPU tensors; the training loop
uploads them to its device.
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import List, Optional

import numpy as np
import torch

from ..config import ModelParams
from ..models.gaussians import GaussianState, init_from_pcd
from ..models.io import load_ply, save_ply
from ..ops.transforms import fov2focal
from .cameras import CameraData, make_camera
from .dataset import (SceneInfo, detect_scene_type, load_image,
                      read_blender_scene, read_colmap_scene)


def _caminfo_to_json(idx: int, ci) -> dict:
    """camera_to_JSON of a raw CameraInfo — ORIGINAL dims, reference
    utils/camera_utils.py:64-84."""
    w2c = np.eye(4)
    w2c[:3, :3] = ci.R.T
    w2c[:3, 3] = ci.T
    c2w = np.linalg.inv(w2c)
    return {
        "id": idx, "img_name": ci.image_name,
        "width": ci.width, "height": ci.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": fov2focal(ci.fovy, ci.height),
        "fx": fov2focal(ci.fovx, ci.width),
    }


class Scene:
    def __init__(self, args: ModelParams, *,
                 load_iteration: Optional[int] = None, shuffle: bool = True,
                 resolution_scales=(1.0,), seed: int = 0, device="cuda"):
        self.model_path = args.model_path
        self.source_path = args.source_path
        self.loaded_iter = None
        self.device = torch.device(device)

        kind = detect_scene_type(args.source_path)
        if kind == "colmap":
            info = read_colmap_scene(args.source_path, args.images,
                                     eval_split=args.eval)
        else:
            info = read_blender_scene(args.source_path,
                                      args.white_background,
                                      eval_split=args.eval)
        self.scene_info: SceneInfo = info
        self.cameras_extent = info.nerf_normalization["radius"]

        if load_iteration is not None:
            if load_iteration == -1:
                load_iteration = search_max_iteration(
                    os.path.join(self.model_path, "point_cloud"))
            self.loaded_iter = load_iteration

        if self.model_path and self.loaded_iter is None:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path,
                            os.path.join(self.model_path, "input.ply"))
            # cameras.json from the RAW CameraInfos — ORIGINAL dims and the
            # reference's test-then-train order, before any shuffle
            cam_json = [
                _caminfo_to_json(i, ci) for i, ci in enumerate(
                    list(info.test_cameras) + list(info.train_cameras))]
            with open(os.path.join(self.model_path, "cameras.json"),
                      "w") as f:
                json.dump(cam_json, f)

        # shuffle the INFO lists once, before building any scale, so every
        # resolution gets the same permutation
        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(info.train_cameras)
            rng.shuffle(info.test_cameras)

        self.train_cameras = {}
        self.test_cameras = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = self._load_cams(
                info.train_cameras, args, scale)
            self.test_cameras[scale] = self._load_cams(
                info.test_cameras, args, scale)

        if self.loaded_iter is not None:
            self.gaussians = load_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.loaded_iter}",
                             "point_cloud.ply"),
                max_sh_degree=args.sh_degree, device=self.device)
        else:
            pts, cols, _ = info.point_cloud
            self.gaussians = init_from_pcd(pts, cols,
                                           max_sh_degree=args.sh_degree,
                                           seed=seed, device=self.device)

    def _load_cams(self, infos, args: ModelParams,
                   scale: float) -> List[CameraData]:
        out = []
        for info in infos:
            img, alpha, (w, h) = load_image(
                info, args.resolution, scale, args.white_background,
                device=self.device)
            cam = make_camera(info.R, info.T, info.fovx, info.fovy, w, h,
                              device=self.device)
            out.append(CameraData(
                camera=cam, image=torch.from_numpy(img),
                alpha_mask=None if alpha is None else torch.from_numpy(alpha),
                image_name=info.image_name, uid=info.uid, R=info.R,
                T=info.T))
        return out

    def save(self, iteration: int, state: GaussianState) -> None:
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        save_ply(state, path)

    def get_train_cameras(self, scale: float = 1.0) -> List[CameraData]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[CameraData]:
        return self.test_cameras[scale]


def search_max_iteration(folder: str) -> int:
    """utils/system_utils.py:26-28 contract."""
    return max(int(f.split("_")[-1]) for f in os.listdir(folder))
