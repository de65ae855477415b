"""Per-Gaussian projective setup (plain torch, differentiable).

Counterpart of ``gs2d_tpu/ops/rasterize/preprocess.py``: build the
splat→pixel homography ``Tm``, its pixel-linear intersection
coefficients, the dual-conic screen-space bounding ellipse, the
view-space normal, and SH→RGB.

Row-vector convention of the reference bridge
(``gaussian_renderer/__init__.py:64-75``):
``Tm = splat2world[rows 0,1,3] @ (full_proj @ ndc2pix)[cols 0,1,3]`` so
that ``[u, v, 1] @ Tm = [x̃, ỹ, w̃]`` with pixel = (x̃/w̃, ỹ/w̃) and w̃ =
camera z. For a pixel (x, y), the ray-splat intersection in homogeneous
splat coordinates is ``p = A + x·B + y·C`` with A = c0×c1, B = c1×c2,
C = c2×c0 (ci the columns of Tm); the kernels consume (A, B, C, c2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..quat import normalize_quat, quat_to_rotmat
from ..sh import eval_sh
from ..transforms import ndc_to_pix_matrix
from ...utils import trace
from .common import (ALPHA_CUTOFF, CULL_MARGIN, FILTER_INV_SQUARE, NEAR_N,
                     SIGMA_CUTOFF)


class PreprocessOut(NamedTuple):
    # differentiable per-Gaussian fields
    A: torch.Tensor        # (N,3)
    B: torch.Tensor        # (N,3)
    C: torch.Tensor        # (N,3)
    c2: torch.Tensor       # (N,3) third homography column (depth coefficients)
    center2d: torch.Tensor  # (N,2) projected ellipse center (px)
    opacity: torch.Tensor  # (N,)
    rgb: torch.Tensor      # (N,3)
    normal: torch.Tensor   # (N,3) view-space, camera-facing
    noise: torch.Tensor    # (N,3) per-Gaussian noise channel
    # non-differentiable aux (consumed by binning; detached)
    depth: torch.Tensor    # (N,) camera-space z of the center
    extent: torch.Tensor   # (N,2) binning half extents in px
    radii: torch.Tensor    # (N,) int32 bounding radius in px (0 = culled)
    visible: torch.Tensor  # (N,) bool
    rho2max: torch.Tensor  # (N,) margin-inflated 2*ln(255*opacity)


def preprocess(
    means3d: torch.Tensor,        # (N,3)
    scales: torch.Tensor,         # (N,2) activated (positive) surfel scales
    quats: torch.Tensor,          # (N,4) wxyz (normalized internally)
    opacities: torch.Tensor,      # (N,) activated in [0,1]
    world_view: torch.Tensor,     # (4,4) row-vector
    full_proj: torch.Tensor,      # (4,4) row-vector
    campos: torch.Tensor,         # (3,)
    width: int,
    height: int,
    sh_degree: int = 0,
    shs: Optional[torch.Tensor] = None,        # (N, (deg+1)^2, 3) or None
    colors: Optional[torch.Tensor] = None,     # (N,3) precomputed, or None
    scale_modifier: float = 1.0,
    screen_offsets: Optional[torch.Tensor] = None,  # (N,2) zeros; see below
    noise: Optional[torch.Tensor] = None,           # (N,3) IG2G noise colors
) -> PreprocessOut:
    N = means3d.shape[0]
    R = quat_to_rotmat(normalize_quat(quats))           # (N,3,3)
    t_u = R[..., :, 0]
    t_v = R[..., :, 1]
    t_w = R[..., :, 2]
    su = scales[..., 0:1] * scale_modifier
    sv = scales[..., 1:2] * scale_modifier

    # two copies from pageable host memory (the matrix, the column
    # index), each of which waits for the stream
    trace.count("sync", 2)
    ndc2pix = torch.as_tensor(ndc_to_pix_matrix(width, height),
                              dtype=means3d.dtype, device=means3d.device)
    world2pix = full_proj @ ndc2pix                      # row-vector
    w2p = world2pix[:, [0, 1, 3]]                        # (4,3): x̃, ỹ, w̃

    # The (N,3)@(3,3) contractions are written out as FMAs, as in the
    # JAX package, so both evaluate the same expression tree.
    def _rows_w2p(r3, affine=False):
        """[r3 | w] @ w2p for row-vector r3 (N,3); w in {0, 1}."""
        out = []
        for j in range(3):
            acc = r3[..., 0] * w2p[0, j] + r3[..., 1] * w2p[1, j] \
                + r3[..., 2] * w2p[2, j]
            if affine:
                acc = acc + w2p[3, j]
            out.append(acc)
        return out  # 3 tensors (N,)

    Tr0 = _rows_w2p(su * t_u)                            # row0: [su·t_u | 0]
    Tr1 = _rows_w2p(sv * t_v)                            # row1: [sv·t_v | 0]
    Tr2 = _rows_w2p(means3d, affine=True)                # row2: [mean | 1]
    c0 = torch.stack([Tr0[0], Tr1[0], Tr2[0]], dim=-1)
    c1 = torch.stack([Tr0[1], Tr1[1], Tr2[1]], dim=-1)
    c2 = torch.stack([Tr0[2], Tr1[2], Tr2[2]], dim=-1)
    A = torch.linalg.cross(c0, c1, dim=-1)
    B = torch.linalg.cross(c1, c2, dim=-1)
    C = torch.linalg.cross(c2, c0, dim=-1)

    # Screen-space gradient side channel: a screen translation by (dx, dy)
    # maps A → A − dx·B − dy·C and leaves B, C, c2 unchanged. With an
    # all-zeros offset tensor that requires grad, its gradient is the
    # per-Gaussian screen-position gradient the densification uses
    # (the reference's retain_grad() means2D tensor).
    if screen_offsets is not None:
        A = A - screen_offsets[..., 0:1] * B - screen_offsets[..., 1:2] * C

    # Dual-conic AABB of the homography image of the splat-frame disc of
    # radius r: the box formula consumes the DUAL conic diag(1,1,-1/r²).
    def _dual_aabb(r2):
        sgn_r = torch.stack([torch.ones_like(r2), torch.ones_like(r2),
                             -1.0 / r2], dim=-1)
        dd = torch.sum(c2 * c2 * sgn_r, dim=-1)          # (N,)
        dd_ok = torch.abs(dd) > 1e-12
        ff = sgn_r / torch.where(dd_ok, dd, torch.ones_like(dd))[..., None]
        cxr = torch.sum(ff * c0 * c2, dim=-1)
        cyr = torch.sum(ff * c1 * c2, dim=-1)
        txr = torch.sum(ff * c0 * c0, dim=-1)
        tyr = torch.sum(ff * c1 * c1, dim=-1)
        h2 = torch.stack([cxr * cxr - txr, cyr * cyr - tyr], dim=-1)
        return cxr, cyr, h2, dd_ok

    op_n = opacities.reshape(N)
    cx, cy, half2, d_ok = _dual_aabb(torch.ones_like(op_n))
    center2d = torch.stack([cx, cy], dim=-1)
    # legacy 3-sigma extent — only for the radii stats channel
    extent3 = SIGMA_CUTOFF * torch.sqrt(torch.clamp(half2, min=1e-4))

    # alpha = opacity*exp(-rho/2) >= ALPHA_CUTOFF iff rho <= rho2max
    rho2max = 2.0 * torch.log(torch.clamp(op_n, min=1e-12) / ALPHA_CUTOFF) \
        + CULL_MARGIN
    rho2m_pos = torch.clamp(rho2max, min=1e-6)
    cxr, cyr, half2r, dr_ok = _dual_aabb(rho2m_pos)
    good_r = dr_ok & (half2r[..., 0] > 0) & (half2r[..., 1] > 0)
    good_r = good_r & torch.all(torch.isfinite(half2r), dim=-1)
    ext_r = torch.sqrt(torch.clamp(half2r, min=0.0))
    # conic box re-centered around center2d; legacy 3-sigma box when the
    # level conic degenerates
    hx = torch.maximum(torch.abs(cxr + ext_r[..., 0] - cx),
                       torch.abs(cx - (cxr - ext_r[..., 0])))
    hy = torch.maximum(torch.abs(cyr + ext_r[..., 1] - cy),
                       torch.abs(cy - (cyr - ext_r[..., 1])))
    conic_half = torch.stack([hx, hy], dim=-1)
    conic_half = torch.where(good_r[..., None], conic_half, extent3)
    # union with the low-pass filter disc around center2d
    fr = torch.sqrt(torch.clamp(rho2max, min=0.0) / FILTER_INV_SQUARE)
    extent = torch.maximum(conic_half, fr[..., None])

    def _mat3_rows(r3, M, shift=None):
        cols = []
        for j in range(3):
            acc = r3[..., 0] * M[0, j] + r3[..., 1] * M[1, j] \
                + r3[..., 2] * M[2, j]
            if shift is not None:
                acc = acc + shift[j]
            cols.append(acc)
        return torch.stack(cols, dim=-1)

    p_view = _mat3_rows(means3d, world_view[:3, :3], world_view[3, :3])
    depth = p_view[..., 2]

    visible = (depth > NEAR_N) & d_ok & (rho2max > 0.0)
    visible = visible & torch.all(torch.isfinite(extent), dim=-1)
    # rect-vs-image overlap cull
    visible = visible & (center2d[..., 0] + extent[..., 0] >= 0.0)
    visible = visible & (center2d[..., 0] - extent[..., 0] <= width - 1.0)
    visible = visible & (center2d[..., 1] + extent[..., 1] >= 0.0)
    visible = visible & (center2d[..., 1] - extent[..., 1] <= height - 1.0)

    radii = torch.where(
        visible,
        torch.ceil(torch.amax(extent3, dim=-1)).to(torch.int32),
        torch.zeros((), dtype=torch.int32, device=means3d.device),
    )

    # view-space normal, flipped toward the camera
    n_view = _mat3_rows(t_w, world_view[:3, :3])
    flip = torch.where(torch.sum(p_view * n_view, dim=-1) < 0.0, 1.0, -1.0)
    n_view = n_view * flip[..., None]

    if colors is not None:
        rgb = colors
    elif shs is not None:
        dirs = means3d - campos
        dirs = dirs * torch.rsqrt(
            torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-16)
        # (N, K, 3) coefficient-major → channel-major for eval_sh
        sh_cm = shs.transpose(-1, -2)
        rgb = torch.clamp(eval_sh(sh_degree, sh_cm, dirs) + 0.5, min=0.0)
    else:
        rgb = torch.ones((N, 3), dtype=means3d.dtype, device=means3d.device)

    if noise is None:
        noise = torch.zeros((N, 3), dtype=means3d.dtype,
                            device=means3d.device)

    return PreprocessOut(
        A=A, B=B, C=C, c2=c2, center2d=center2d,
        opacity=op_n, rgb=rgb, normal=n_view, noise=noise,
        depth=depth.detach(), extent=extent.detach(), radii=radii,
        visible=visible, rho2max=rho2max.detach(),
    )
