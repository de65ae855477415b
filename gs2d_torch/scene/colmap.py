"""COLMAP binary/text model parsers and writers (plain ``struct``/NumPy).

Copy of ``gs2d_tpu/scene/colmap.py`` (the port imports nothing from the
JAX package): cameras.bin / images.bin / points3D.bin and their .txt
variants, after the COLMAP file-format spec. Only PINHOLE / SIMPLE_PINHOLE
intrinsics are consumed downstream (``dataset.py``), but all models parse.
The JAX package's native fast path for images.bin and points3D.bin is not
carried over: these readers always return the full observation tables.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict

import numpy as np

# model_id → (name, num_params); COLMAP's camera model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # (4,) wxyz
    tvec: np.ndarray   # (3,)
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → wxyz quaternion (largest-component method)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self.off)
        self.off += struct.calcsize("<" + fmt)
        return vals

    def read_string(self) -> str:
        end = self.data.index(b"\x00", self.off)
        s = self.data[self.off:end].decode("utf-8")
        self.off = end + 1
        return s


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    (num,) = r.read("Q")
    out = {}
    for _ in range(num):
        cam_id, model_id = r.read("ii")
        width, height = r.read("QQ")
        name, nparams = CAMERA_MODELS[model_id]
        params = np.array(r.read("d" * nparams))
        out[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    (num,) = r.read("Q")
    out = {}
    for _ in range(num):
        (img_id,) = r.read("i")
        qvec = np.array(r.read("dddd"))
        tvec = np.array(r.read("ddd"))
        (cam_id,) = r.read("i")
        name = r.read_string()
        (npts,) = r.read("Q")
        blob = np.frombuffer(r.data, dtype=np.float64,
                             count=npts * 3, offset=r.off).reshape(npts, 3)
        r.off += npts * 24
        xys = blob[:, :2].copy()
        ids = blob[:, 2].copy().view(np.int64)
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, ids)
    return out


def read_points3d_binary(path: str):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, error (N,))."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    (num,) = r.read("Q")
    xyz = np.empty((num, 3))
    rgb = np.empty((num, 3), np.uint8)
    err = np.empty((num,))
    for i in range(num):
        r.read("q")                       # point id
        xyz[i] = r.read("ddd")
        rgb[i] = r.read("BBB")
        (err[i],) = r.read("d")
        (track_len,) = r.read("Q")
        r.off += track_len * 8
    return xyz, rgb, err


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            out[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(x) for x in parts[4:]]))
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        # keep EMPTY lines: COLMAP always writes the POINTS2D line, and
        # it is blank for an image with zero observations — dropping it
        # shifts the 2-lines-per-image pairing and corrupts every pose
        # after it
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        pts = np.array([float(x) for x in elems]).reshape(-1, 3) \
            if elems else np.zeros((0, 3))
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name,
                                  pts[:, :2], pts[:, 2].astype(np.int64))
    return out


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(x) for x in p[1:4]])
            rgb.append([int(x) for x in p[4:7]])
            err.append(float(p[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, MODEL_NAME_TO_ID[c.model],
                                c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(imgs: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            blob = np.empty((n, 3), np.float64)
            blob[:, :2] = im.xys
            blob[:, 2] = np.asarray(im.point3d_ids, np.int64).view(np.float64)
            f.write(blob.tobytes())


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray,
                          path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<q", i))
            f.write(struct.pack("<ddd", *xyz[i]))
            f.write(struct.pack("<BBB", *rgb[i]))
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))


def detect_model_dir(base: str) -> str:
    """Locate sparse/0 (or sparse/) under a COLMAP scene directory."""
    for cand in (os.path.join(base, "sparse", "0"),
                 os.path.join(base, "sparse")):
        if (os.path.exists(os.path.join(cand, "cameras.bin"))
                or os.path.exists(os.path.join(cand, "cameras.txt"))):
            return cand
    raise FileNotFoundError(f"no COLMAP model under {base}")
