"""Model PLY IO with the exact 3DGS attribute schema
(reference ``scene/gaussian_model.py:176-255``; ``gs2d_tpu/models/io.py``
``save_ply``/``load_ply``), so a model ``train.py`` writes renders here.
Checkpoints with optimizer state come with the training loop."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..scene.ply import read_ply, write_ply
from .gaussians import GaussianParams, GaussianState


def save_ply(state: GaussianState, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    p = {f: getattr(state.params, f).detach().cpu().numpy()
         for f in ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity")}
    n = p["xyz"].shape[0]
    cols = {"x": p["xyz"][:, 0], "y": p["xyz"][:, 1], "z": p["xyz"][:, 2],
            "nx": np.zeros(n), "ny": np.zeros(n), "nz": np.zeros(n)}
    # features are stored channel-major flattened like the reference
    # (transpose(1,2).flatten → channel varies slower than coefficient)
    fdc = p["features_dc"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(fdc.shape[1]):
        cols[f"f_dc_{i}"] = fdc[:, i]
    frest = p["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(frest.shape[1]):
        cols[f"f_rest_{i}"] = frest[:, i]
    cols["opacity"] = p["opacity"][:, 0]
    for i in range(p["scaling"].shape[1]):
        cols[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(p["rotation"].shape[1]):
        cols[f"rot_{i}"] = p["rotation"][:, i]
    write_ply(path, cols)


def load_ply(path: str, max_sh_degree: int = 3,
             device="cuda") -> GaussianState:
    cols = read_ply(path)
    n = len(cols["x"])
    K = (max_sh_degree + 1) ** 2

    def grab(prefix, count):
        names = sorted((k for k in cols if k.startswith(prefix)),
                       key=lambda s: int(s.rsplit("_", 1)[1]))
        if len(names) != count:
            raise ValueError(f"{path}: {len(names)} '{prefix}*' columns, "
                             f"expected {count} for SH degree "
                             f"{max_sh_degree}")
        return np.stack([cols[k] for k in names], -1)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    fdc = grab("f_dc_", 3).reshape(n, 3, 1).transpose(0, 2, 1)
    frest = grab("f_rest_", 3 * (K - 1)).reshape(n, 3, K - 1) \
        .transpose(0, 2, 1)
    params = GaussianParams(
        xyz=dev(np.stack([cols["x"], cols["y"], cols["z"]], -1)),
        features_dc=dev(fdc), features_rest=dev(frest),
        scaling=dev(grab("scale_", 2)), rotation=dev(grab("rot_", 4)),
        opacity=dev(cols["opacity"][:, None]))
    # a loaded model renders at its full degree (reference load_ply:255)
    return GaussianState(params=params, active_sh_degree=max_sh_degree)
