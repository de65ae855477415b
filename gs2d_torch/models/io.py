"""Model IO (``gs2d_tpu/models/io.py``).

(a) PLY snapshots with the exact 3DGS attribute schema (reference
    ``scene/gaussian_model.py:176-255``), so a model ``train.py`` writes
    renders here;
(b) the full training state — parameters, Adam moments, densification
    statistics, step — as an npz in the JAX package's key schema, so a
    JAX checkpoint resumes in the port and a port checkpoint in the JAX
    package.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..scene.ply import read_ply, write_ply
from ..train.optim import FIELDS, AdamState
from .gaussians import GaussianParams, GaussianState, state_from_numpy


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


def save_checkpoint(path: str, state: GaussianState, opt: AdamState,
                    iteration: int, spatial_lr_scale: float = 1.0) -> None:
    """Write the training state in the JAX npz schema
    (``gs2d_tpu/models/io.py:94-110``): ``p.*``, ``mu.*``, ``nu.*`` per
    parameter field, ``active`` (all true: the port holds only live
    rows), ``active_sh_degree``, the three statistics, ``opt_step``,
    ``iteration`` and ``spatial_lr_scale``. The arrays are stored
    uncompressed; ``np.load`` reads both forms."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def host(x):
        return x.detach().cpu().numpy()

    flat = {f"{name}.{f}": host(getattr(tree, f))
            for name, tree in (("p", state.params), ("mu", opt.mu),
                               ("nu", opt.nu)) for f in FIELDS}
    n = state.params.xyz.shape[0]
    np.savez(path, **flat,
             active=np.ones(n, bool),
             active_sh_degree=np.int32(state.active_sh_degree),
             max_radii2d=host(state.max_radii2d),
             grad_accum=host(state.grad_accum),
             denom=host(state.denom),
             opt_step=np.int32(opt.step),
             iteration=np.int64(iteration),
             spatial_lr_scale=np.float64(spatial_lr_scale))


def load_checkpoint(path: str, device="cuda"
                    ) -> Tuple[GaussianState, AdamState, int, float]:
    """Read a checkpoint of either package → (state, Adam state,
    iteration, spatial_lr_scale) on ``device``. Only the rows marked
    ``active`` are kept (a JAX checkpoint holds capacity padding)."""
    with np.load(path) as z:
        act = z["active"]
        state = state_from_numpy(
            **{f: z[f"p.{f}"] for f in FIELDS}, active=act,
            active_sh_degree=z["active_sh_degree"],
            max_radii2d=z["max_radii2d"], grad_accum=z["grad_accum"],
            denom=z["denom"], device=device)

        def tree(prefix):
            return GaussianParams(**{
                f: torch.as_tensor(np.ascontiguousarray(
                    z[f"{prefix}.{f}"][act], np.float32), device=device)
                for f in FIELDS})

        opt = AdamState(mu=tree("mu"), nu=tree("nu"),
                        step=int(z["opt_step"]))
        return state, opt, int(z["iteration"]), float(z["spatial_lr_scale"])
