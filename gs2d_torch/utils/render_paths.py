"""Camera trajectory utilities for free-view video export.

NumPy copy of ``gs2d_tpu/utils/render_paths.py`` (the reference's
``utils/render_utils.py``, multinerf-derived): focus-point estimation, PCA
pose normalization, elliptical orbit paths, Camera generation, and video
export. The JAX package writes an mp4v file through cv2, which the card's
machine lacks; ``create_video`` writes an uncompressed RGB24 AVI instead,
lossless, in NumPy and ``struct``.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np


def normalize(x):
    return x / np.linalg.norm(x)


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Least-squares intersection of the camera optical axes.

    Camera i contributes the line o_i + s·d_i (position, +z axis); the
    squared distance of a point p to it is |P_i (p − o_i)|² with
    P_i = I − d_i d_iᵀ the projector onto the plane normal to d_i.
    Projectors are symmetric and idempotent, so the normal equations of
    min_p Σ_i |P_i (p − o_i)|² collapse to (Σ_i P_i) p = Σ_i P_i o_i —
    one 3×3 solve, no Gram-matrix detour. Same capability as
    the reference's utils/render_utils.py:68-74 (multinerf-derived),
    re-derived here from the projector normal equations."""
    d = poses[:, :3, 2]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = poses[:, :3, 3]
    proj = np.eye(3)[None] - d[:, :, None] * d[:, None, :]   # (n, 3, 3)
    return np.linalg.solve(proj.sum(0), np.einsum("nij,nj->i", proj, o))


def transform_poses_pca(poses: np.ndarray):
    """Normalize a capture's world frame from its camera layout: recenter
    positions at their centroid, rotate the principal spread axes onto
    world x/y/z (largest first), pick a canonical handedness/up sign, and
    scale positions into the unit box.

    Returns (new_poses, transform): new_poses keep orthonormal rotations
    with scaled translations; transform is the (3, 4) similarity (scaled
    rotation + shift) that maps original positions to new ones, so
    callers can carry generated paths back with its inverse. Same
    capability as the reference's utils/render_utils.py:76-107
    (multinerf-derived); re-derived here via the SVD of the centered
    position matrix — its right singular vectors are the principal axes
    already ordered by spread, so no eigensystem sort is needed."""
    centers = poses[:, :3, 3]
    centroid = centers.mean(axis=0)
    _, _, axes = np.linalg.svd(centers - centroid)   # rows: spread axes
    if np.linalg.det(axes) < 0:
        axes = -axes                       # proper rotation (det −A = −det A)
    # canonical up: mean camera y-axis should map to +z; rotate π about x
    # otherwise (det-preserving)
    if (axes @ poses[:, :3, 1].mean(axis=0))[2] < 0:
        axes = np.diag([1.0, -1.0, -1.0]) @ axes
    shift = -axes @ centroid
    new_centers = centers @ axes.T + shift
    scale = 1.0 / np.max(np.abs(new_centers))
    new_poses = np.concatenate(
        [axes @ poses[:, :3, :3], (scale * new_centers)[:, :, None]],
        axis=-1)
    transform = np.concatenate([scale * axes, scale * shift[:, None]],
                               axis=-1)
    return new_poses, transform


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0,
                          z_phase: float = 0.0) -> np.ndarray:
    """Elliptical orbit through the camera centers at the focus height
    (reference :121-170)."""
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            # reference: path height sits at z=0 (zero-mean capture
            # pattern after PCA recentering) — no focus-height offset
            z_variation * (z_low[2] + (z_high - z_low)[2]
                           * (np.cos(theta + 2 * np.pi * z_phase)
                              * 0.5 + 0.5)),
        ], -1)

    theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)
    avg_up = poses[:, :3, 1].mean(0)
    avg_up = avg_up / np.linalg.norm(avg_up)
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])

    return np.stack(
        [viewmatrix(p - center, up, p) for p in positions[:-1]])


def viewmatrix(lookdir, up, position):
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def generate_path(viewpoint_cameras, n_frames: int = 480) -> List:
    """Generate Camera objects along an ellipse path (reference
    :173-194), on the device of the first view's camera."""
    from ..scene.cameras import make_camera
    c2ws = np.array([np.linalg.inv(cd.camera.world_view.T.cpu().numpy())
                     for cd in viewpoint_cameras])
    pose = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
    pose_recenter, colmap_to_world_transform = transform_poses_pca(pose)
    new_poses = generate_ellipse_path(pose_recenter, n_frames=n_frames)
    new_poses = unpad_poses(
        np.linalg.inv(pad_poses(colmap_to_world_transform))
        @ pad_poses(new_poses))

    ref = viewpoint_cameras[0].camera
    # even dims like the reference (int(w/2)*2): odd-dimension frames
    # break 4:2:0 video encoders downstream
    vw, vh = (ref.width // 2) * 2, (ref.height // 2) * 2
    out = []
    for pose in new_poses:
        c2w = pad_poses(pose @ np.diag([1, -1, -1, 1]))
        w2c = np.linalg.inv(c2w)
        out.append(make_camera(
            w2c[:3, :3].T, w2c[:3, 3], ref.fovx, ref.fovy, vw, vh,
            device=ref.device))
    return out


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\0" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(kind: bytes, data: bytes) -> bytes:
    return _chunk(b"LIST", kind + data)


def create_video(frames: List[np.ndarray], path: str, fps: int = 30):
    """Write (H, W, 3) RGB frames in [0, 1] (uint8 after clip and ×255,
    truncated, as the JAX writer converts) to ``path`` as an uncompressed
    AVI: one video stream of top-down (negative height) BGR ``DIB ``
    frames (BI_RGB, 24 bits, rows padded to 4 bytes) and an ``idx1``
    index. Top-down, because FFmpeg's bottom-up path (behind OpenCV's
    reader) returned corrupt frames."""
    if not frames:
        return
    h, w = frames[0].shape[:2]
    stride = (3 * w + 3) // 4 * 4
    size = stride * h
    movi, index = [], []
    for k, f in enumerate(frames):
        if f.shape[:2] != (h, w):
            raise ValueError(f"frame {k} is {f.shape[:2]}, not {(h, w)}")
        img = (np.clip(f, 0, 1) * 255).astype(np.uint8)
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :3 * w] = img[:, :, ::-1].reshape(h, 3 * w)
        index.append(struct.pack("<4sIII", b"00db", 0x10,
                                 4 + k * (8 + size), size))
        movi.append(_chunk(b"00db", rows.tobytes()))
    n = len(frames)
    avih = struct.pack("<14I", round(1e6 / fps), size * fps, 0, 0x10, n, 0,
                       1, size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0, 0, 0,
                       1, fps, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0,
                       0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    body = b"AVI " + hdrl + _list(b"movi", b"".join(movi)) \
        + _chunk(b"idx1", b"".join(index))
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
