"""Per-group Adam on explicit moment tensors.

Counterpart of ``gs2d_tpu/train/optim.py``: the reference's
``torch.optim.Adam`` with per-group learning rates
(``scene/gaussian_model.py:148-166``), eps 1e-15, betas (0.9, 0.999),
written out as a function so that (a) the bias correction is ordered as
in the JAX package, ``(m / c1) / (sqrt(v / c2) + eps)`` with one global
step, and (b) densification can cut and concatenate moment rows directly.
The port holds only live Gaussians, so there is no mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.gaussians import GaussianParams

B1 = 0.9
B2 = 0.999
EPS = 1e-15
FIELDS = tuple(f.name for f in dataclasses.fields(GaussianParams))


@dataclasses.dataclass
class AdamState:
    mu: GaussianParams   # first moments
    nu: GaussianParams   # second moments
    step: int            # updates taken


def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(
        mu=GaussianParams(**{f: torch.zeros_like(getattr(params, f))
                             for f in FIELDS}),
        nu=GaussianParams(**{f: torch.zeros_like(getattr(params, f))
                             for f in FIELDS}),
        step=0)


@torch.no_grad()
def adam_step(params: GaussianParams, grads: GaussianParams,
              opt: AdamState, lrs: GaussianParams):
    """One Adam update → (new params, new AdamState). ``lrs`` holds one
    float learning rate per field. The bias corrections are float32, as
    the JAX package computes them."""
    step = opt.step + 1
    c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(step))
    c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(step))
    new_p, new_m, new_v = {}, {}, {}
    for f in FIELDS:
        p, g = getattr(params, f), getattr(grads, f)
        m_new = B1 * getattr(opt.mu, f) + (1 - B1) * g
        v_new = B2 * getattr(opt.nu, f) + (1 - B2) * g * g
        new_p[f] = p - getattr(lrs, f) * (m_new / c1) / (
            torch.sqrt(v_new / c2) + EPS)
        new_m[f] = m_new
        new_v[f] = v_new
    return (GaussianParams(**new_p),
            AdamState(mu=GaussianParams(**new_m), nu=GaussianParams(**new_v),
                      step=step))


def make_lrs(xyz_lr: float, *, feature_lr: float = 0.0025,
             opacity_lr: float = 0.05, scaling_lr: float = 0.005,
             rotation_lr: float = 0.001) -> GaussianParams:
    """Per-group LRs (reference :153-160); ``xyz_lr`` is the scheduled
    value, already scaled by the scene extent."""
    return GaussianParams(xyz=float(xyz_lr), features_dc=feature_lr,
                          features_rest=feature_lr / 20.0,
                          scaling=scaling_lr, rotation=rotation_lr,
                          opacity=opacity_lr)
