"""Gaussian surfel parameter state.

Counterpart of ``gs2d_tpu/models/gaussians.py:27-97``. The JAX package
keeps fixed-capacity arrays with an ``active`` mask because XLA needs
static shapes; tensors here hold only the live Gaussians, as the
reference ``GaussianModel`` does. Activation contract of the reference
(``scene/gaussian_model.py:26-41``): exp on the 2 log-scales, sigmoid
opacity, quaternions normalised inside preprocess. SH features use the
reference's (N, K, 3) coefficient-major layout split into DC (K=1) and
rest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.knn import mean_sq_dist3
from ..ops.sh import num_sh_coeffs, rgb_to_sh


@dataclasses.dataclass
class GaussianParams:
    xyz: torch.Tensor            # (N, 3)
    features_dc: torch.Tensor    # (N, 1, 3)
    features_rest: torch.Tensor  # (N, K-1, 3)
    scaling: torch.Tensor        # (N, 2) log-scale
    rotation: torch.Tensor       # (N, 4) unnormalized wxyz
    opacity: torch.Tensor        # (N, 1) logit


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    active_sh_degree: int        # ramped +1 / 1000 iterations in training
    # densification statistics (reference :405-407), (N,) f32 each, zeros
    # when not given: the largest radius, the sum of screen-gradient
    # norms and the number of steps the Gaussian was visible
    max_radii2d: Optional[torch.Tensor] = None
    grad_accum: Optional[torch.Tensor] = None
    denom: Optional[torch.Tensor] = None

    def __post_init__(self):
        xyz = self.params.xyz
        for f in ("max_radii2d", "grad_accum", "denom"):
            if getattr(self, f) is None:
                setattr(self, f, torch.zeros(xyz.shape[0], dtype=torch.float32,
                                             device=xyz.device))


def init_from_pcd(points: np.ndarray, colors: np.ndarray,
                  max_sh_degree: int = 3,
                  init_scales: Optional[np.ndarray] = None, seed: int = 0,
                  device="cuda") -> GaussianState:
    """The reference ``create_from_pcd`` contract
    (``gaussian_model.py:124-146``; ``gs2d_tpu/models/gaussians.py:100-144``
    without capacity): DC features from RGB2SH, log-scales from the mean
    squared distance to the 3 nearest neighbours (``ops/knn.py``, on
    ``device``) unless ``init_scales`` is given, rotations from
    ``np.random.default_rng(seed)`` as the JAX package draws them, and an
    opacity logit of 0.1, at SH degree 0."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    K = num_sh_coeffs(max_sh_degree)
    rng = np.random.default_rng(seed)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    xyz = dev(points)
    if init_scales is None:
        d2 = torch.clamp(mean_sq_dist3(xyz), min=1e-7)
        scaling = torch.log(torch.sqrt(d2))[:, None].repeat(1, 2)
    else:
        scaling = dev(init_scales)
    f32 = np.float32
    logit = np.log(f32(0.1) / (f32(1.0) - f32(0.1)))
    params = GaussianParams(
        xyz=xyz,
        features_dc=dev(rgb_to_sh(np.asarray(colors, np.float32))[:, None]),
        features_rest=torch.zeros((n, K - 1, 3), dtype=torch.float32,
                                  device=device),
        scaling=scaling,
        rotation=dev(rng.random((n, 4))),
        opacity=dev(np.full((n, 1), logit)))
    return GaussianState(params=params, active_sh_degree=0)


def state_from_numpy(xyz, features_dc, features_rest, scaling, rotation,
                     opacity, active, active_sh_degree, max_radii2d=None,
                     grad_accum=None, denom=None,
                     device="cuda") -> GaussianState:
    """Carry a JAX ``GaussianState`` over as NumPy arrays.

    The arrays are the JAX fields (capacity-padded); ``active`` (cap,)
    selects the live rows, since the port has no capacity padding. The
    densification statistics are zeros where not given."""
    act = np.asarray(active, bool)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x)[act],
                                                    np.float32),
                               device=device)

    params = GaussianParams(
        xyz=dev(xyz), features_dc=dev(features_dc),
        features_rest=dev(features_rest), scaling=dev(scaling),
        rotation=dev(rotation), opacity=dev(opacity))
    stats = {k: None if v is None else dev(v) for k, v in (
        ("max_radii2d", max_radii2d), ("grad_accum", grad_accum),
        ("denom", denom))}
    return GaussianState(params=params,
                         active_sh_degree=int(np.asarray(active_sh_degree)),
                         **stats)
