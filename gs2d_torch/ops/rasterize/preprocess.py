"""Per-Gaussian projective setup.

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

Two entries:

- ``preprocess``: plain torch under autograd, on activated inputs (scales,
  opacities in [0, 1], SH coefficients); the JAX package's counterpart.
- ``preprocess_packed``: the render's (``renderer.prepare``). From the
  raw parameters (log-scales, opacity logits, the SH features as the
  state holds them, an active SH degree) to K1's (N, 24) record and the
  binning's detached aux, in one ``torch.autograd.Function``: on CUDA
  tensors its forward is the kernel ``csrc/preprocess_fwd.cu`` and its
  backward ``csrc/preprocess_bwd.cu``; on CPU tensors their plain
  versions ``preprocess_fwd_reference`` (``preprocess`` then
  ``pack_entries``) and ``preprocess_bwd_reference`` (the same gradient
  written out, in the order the backward kernel computes it).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ... import cuda_build
from ...utils import trace
from ..quat import quat_to_rotmat
from ..sh import C0, C1, C2, C3, C4, eval_sh
from .common import (ALPHA_CUTOFF, CULL_MARGIN, ENTRY_F, FILTER_INV_SQUARE,
                     NEAR_N, SIGMA_CUTOFF)


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
    # K1's (N, 24) record whose columns the differentiable fields above
    # are (``preprocess_packed``); None where they are tensors of their
    # own. The rule: code that edits a field drops it (``shift_viewport``
    # passes ``packed=None``), and ``gather_records`` builds fields of
    # its own. ``pack_entries`` is the rule's safety net (see there).
    packed: Optional[torch.Tensor] = None


def world_to_pix(full_proj: torch.Tensor, width: int,
                 height: int) -> torch.Tensor:
    """(4, 3): columns x̃, ỹ, w̃ of ``full_proj @ ndc2pix``, where ndc2pix
    maps NDC to pixels as the reference's
    ``gaussian_renderer/__init__.py:69-73`` does (x̃ = x·W/2 + w·(W−1)/2,
    half-pixel-centred, ỹ likewise, w̃ = w; its z column is never used),
    written out on ``full_proj``'s device, so that nothing is copied from
    the host."""
    W, H = float(width), float(height)
    w = full_proj[:, 3]
    return torch.stack([full_proj[:, 0] * (W / 2) + w * ((W - 1) / 2),
                        full_proj[:, 1] * (H / 2) + w * ((H - 1) / 2), w],
                       dim=1)


_RECORD_FIELDS = ("A", "B", "C", "c2", "center2d", "opacity", "rgb",
                  "normal", "noise")


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """v[..., 0] + v[..., 1] + v[..., 2], in that order."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def pack_entries(pre: PreprocessOut) -> torch.Tensor:
    """Per-Gaussian kernel record, layout per common.py FLD_*: (N, 24).

    ``pre.packed`` where ``pre`` carries it. Otherwise the fields
    concatenated, and a row with any non-finite value zeroed: its p2 is
    then 0, so the kernels skip it and its gradient is zero
    (``gs2d_tpu/ops/rasterize/api.py:347-348``). The safety net of
    ``PreprocessOut.packed``'s rule: a field swapped with ``_replace``
    that kept ``packed`` (a test's or a check's leaves of its own) is no
    view of the record, and then the fields are packed, so the record
    never goes stale."""
    if pre.packed is not None and all(
            getattr(pre, f)._base is pre.packed for f in _RECORD_FIELDS):
        return pre.packed
    packed = torch.cat(
        [pre.A, pre.B, pre.C, pre.c2, pre.center2d, pre.opacity[:, None],
         pre.rgb, pre.normal, pre.noise], dim=-1)
    finite = torch.isfinite(packed).all(dim=1, keepdim=True)
    return torch.where(finite, packed, torch.zeros_like(packed))


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
    # The sums over a vector's entries are written out left to right, as
    # the kernels (csrc/preprocess_common.cuh) add them.
    q = quats
    qn = torch.sqrt(q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]
                    + q[..., 2] * q[..., 2] + q[..., 3] * q[..., 3])
    R = quat_to_rotmat(q / torch.clamp(qn, min=1e-12)[..., None])  # (N,3,3)
    t_u = R[..., :, 0]
    t_v = R[..., :, 1]
    t_w = R[..., :, 2]
    su = scales[..., 0:1] * scale_modifier
    sv = scales[..., 1:2] * scale_modifier

    w2p = world_to_pix(full_proj, width, height)        # (4,3): x̃, ỹ, w̃

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
        dd = _sum3(c2 * c2 * sgn_r)                      # (N,)
        dd_ok = torch.abs(dd) > 1e-12
        ff = sgn_r / torch.where(dd_ok, dd, torch.ones_like(dd))[..., None]
        cxr = _sum3(ff * c0 * c2)
        cyr = _sum3(ff * c1 * c2)
        txr = _sum3(ff * c0 * c0)
        tyr = _sum3(ff * c1 * c1)
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
    flip = torch.where(_sum3(p_view * n_view) < 0.0, 1.0, -1.0)
    n_view = n_view * flip[..., None]

    if colors is not None:
        rgb = colors
    elif shs is not None:
        dirs = means3d - campos
        dirs = dirs * torch.rsqrt(
            _sum3(dirs * dirs)[..., None] + 1e-16)
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


# --------------------------------------------------------------------------
# The render's entry: raw parameters → K1's record, one autograd Function

def _check_inputs(xyz, scaling, rotation, opacity, features_dc, features_rest,
                  colors, noise, screen_offsets, world_view, full_proj,
                  campos, width, height, sh_degree) -> int:
    """Raise unless the inputs are what both kernels take; returns the
    number K of SH coefficients a surfel holds (0 with ``colors``)."""
    if (features_dc is None) != (features_rest is None) \
            or (colors is None) == (features_dc is None):
        raise ValueError("preprocess_packed takes SH features (features_dc "
                         "and features_rest) or colors: one of the two")
    n = xyz.shape[0]
    K = 0
    if features_rest is not None:
        K = features_rest.shape[1] + 1 if features_rest.dim() == 3 else 0
        max_deg = math.isqrt(K) - 1
        if (max_deg + 1) ** 2 != K or not 0 <= max_deg <= 4:
            raise ValueError(f"features hold {K} SH coefficients a surfel, "
                             f"not (d + 1)^2 for a degree d in [0, 4]")
        if not 0 <= sh_degree <= max_deg:
            raise ValueError(f"SH degree {sh_degree} outside [0, {max_deg}]")
    shapes = {"xyz": (xyz, (n, 3)), "scaling": (scaling, (n, 2)),
              "rotation": (rotation, (n, 4)), "opacity": (opacity, (n, 1)),
              "features_dc": (features_dc, (n, 1, 3)),
              "features_rest": (features_rest, (n, K - 1, 3)),
              "colors": (colors, (n, 3)), "noise": (noise, (n, 3)),
              "screen_offsets": (screen_offsets, (n, 2)),
              "world_view": (world_view, (4, 4)),
              "full_proj": (full_proj, (4, 4)), "campos": (campos, (3,))}
    for name, (x, shape) in shapes.items():
        if x is None:
            continue
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} float32 "
                             f"tensor, got {tuple(x.shape)} {x.dtype}")
        if x.device != xyz.device:
            raise ValueError(f"{name} is on {x.device}, xyz on {xyz.device}")
    if width <= 0 or height <= 0:
        raise ValueError(f"image size must be positive, got {width}x{height}")
    return K


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _on_card(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return x.device.type == "cuda"


@functools.cache
def _fwd_kernel():
    """The C entry point of csrc/preprocess_fwd.cu, built at first use."""
    fn = cuda_build.load("preprocess_fwd").gs2d_preprocess_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 7)
    return fn


@functools.cache
def _bwd_kernel():
    """The C entry point of csrc/preprocess_bwd.cu, built at first use."""
    fn = cuda_build.load("preprocess_bwd").gs2d_preprocess_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 10)
    return fn


def preprocess_fwd(xyz, scaling, rotation, opacity, features_dc,
                   features_rest, colors, noise, screen_offsets, world_view,
                   full_proj, campos, width: int, height: int,
                   sh_degree: int, scale_modifier: float = 1.0):
    """K1's record and the binning's aux from the raw parameters.

    xyz (N, 3), scaling (N, 2) log-scales, rotation (N, 4) wxyz as stored,
    opacity (N, 1) logits; SH features (N, 1, 3) and (N, K − 1, 3)
    evaluated at ``sh_degree`` (coefficients above it read as zero), or
    ``colors`` (N, 3) in their place; ``noise`` (N, 3) or None (zeros);
    ``screen_offsets`` (N, 2) or None; the camera's row-vector
    ``world_view``, ``full_proj`` and ``campos``, on the same device. All
    contiguous float32. Returns (packed (N, 24) in the FLD_* layout, a
    non-finite row zeroed; depth (N,); extent (N, 2); radii (N,) int32;
    visible (N,) bool, False for a zeroed row; rho2max (N,)). A CPU
    tensor runs ``preprocess_fwd_reference``; a CUDA tensor launches the
    kernel or raises."""
    inputs = (xyz, scaling, rotation, opacity, features_dc, features_rest,
              colors, noise, screen_offsets, world_view, full_proj, campos)
    K = _check_inputs(*inputs, width, height, sh_degree)
    if not _on_card("preprocess_fwd", xyz):
        return preprocess_fwd_reference(*inputs, width, height, sh_degree,
                                        scale_modifier)
    n, dev = xyz.shape[0], xyz.device
    outs = (torch.empty((n, ENTRY_F), dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty((n, 2), dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev))
    if n:
        fn = _fwd_kernel()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*map(_ptr, inputs), max(K - 1, 0), sh_degree, width,
                     height, scale_modifier, n, *map(_ptr, outs), stream)
        if err != 0:
            raise RuntimeError(f"preprocess_fwd kernel launch failed: CUDA "
                               f"error {err}")
        preprocess_fwd.launches += 1
        trace.count("preprocess.kernel")
    return outs


preprocess_fwd.launches = 0   # kernel launches since the last reset


def preprocess_bwd(d_packed, xyz, scaling, rotation, opacity, features_dc,
                   features_rest, colors, noise, screen_offsets, world_view,
                   full_proj, campos, width: int, height: int,
                   sh_degree: int, scale_modifier: float = 1.0):
    """The gradient of ``preprocess_fwd``'s record: from d_packed (N, 24)
    and the forward's inputs, the gradients of xyz, scaling, rotation,
    opacity, features_dc, features_rest, colors, noise and
    screen_offsets, each in its input's layout; None for an input that is
    None. A row
    the forward zeroed gets zero gradient; features above ``sh_degree``
    get exact zeros. A CPU tensor runs ``preprocess_bwd_reference``; a
    CUDA tensor launches the kernel or raises."""
    inputs = (xyz, scaling, rotation, opacity, features_dc, features_rest,
              colors, noise, screen_offsets, world_view, full_proj, campos)
    K = _check_inputs(*inputs, width, height, sh_degree)
    n = xyz.shape[0]
    if d_packed.dtype != torch.float32 or tuple(d_packed.shape) != (
            n, ENTRY_F) or not d_packed.is_contiguous() \
            or d_packed.device != xyz.device:
        raise ValueError(f"d_packed must be a contiguous ({n}, {ENTRY_F}) "
                         f"float32 tensor on {xyz.device}, got "
                         f"{tuple(d_packed.shape)} {d_packed.dtype} on "
                         f"{d_packed.device}")
    if not _on_card("preprocess_bwd", xyz):
        return preprocess_bwd_reference(d_packed, *inputs, width, height,
                                        sh_degree, scale_modifier)
    grads = tuple(None if x is None else torch.empty_like(x)
                  for x in inputs[:9])
    if n:
        fn = _bwd_kernel()
        with torch.cuda.device(xyz.device):
            stream = torch.cuda.current_stream(xyz.device).cuda_stream
            err = fn(d_packed.data_ptr(), *map(_ptr, inputs), max(K - 1, 0),
                     sh_degree, width, height, scale_modifier, n,
                     *map(_ptr, grads), stream)
        if err != 0:
            raise RuntimeError(f"preprocess_bwd kernel launch failed: CUDA "
                               f"error {err}")
        preprocess_bwd.launches += 1
    return grads


preprocess_bwd.launches = 0   # kernel launches since the last reset


def _sh_mask(sh_degree: int, num_coeffs: int, device) -> torch.Tensor:
    """(K, 1) multiplier zeroing the coefficients above ``sh_degree``
    (the reference's active_sh_degree ramp, train.py:61-62)."""
    deg = torch.floor(torch.sqrt(torch.arange(num_coeffs,
                                              dtype=torch.float32,
                                              device=device)))
    return (deg <= sh_degree).to(torch.float32)[:, None]


def _activated_preprocess(xyz, scaling, rotation, opacity, features_dc,
                          features_rest, colors, noise, screen_offsets,
                          world_view, full_proj, campos, width, height,
                          sh_degree, scale_modifier) -> PreprocessOut:
    """The activation, the SH mask and ``preprocess``, op for op as the
    render computed them before the kernels."""
    shs, deg = None, 0
    if colors is None:
        K = features_rest.shape[1] + 1
        deg = math.isqrt(K) - 1
        shs = torch.cat([features_dc, features_rest], dim=1) \
            * _sh_mask(sh_degree, K, xyz.device)
    return preprocess(xyz, torch.exp(scaling), rotation,
                      torch.sigmoid(opacity)[:, 0], world_view, full_proj,
                      campos, width, height, sh_degree=deg, shs=shs,
                      colors=colors, scale_modifier=scale_modifier,
                      screen_offsets=screen_offsets, noise=noise)


def preprocess_fwd_reference(xyz, scaling, rotation, opacity, features_dc,
                             features_rest, colors, noise, screen_offsets,
                             world_view, full_proj, campos, width: int,
                             height: int, sh_degree: int,
                             scale_modifier: float = 1.0):
    """Plain PyTorch version of ``preprocess_fwd``: ``preprocess`` on the
    activated parameters, then ``pack_entries``; a row that it zeroes is
    not ``visible``, so binning lists it nowhere, and keeps its radii."""
    pre = _activated_preprocess(xyz, scaling, rotation, opacity, features_dc,
                                features_rest, colors, noise, screen_offsets,
                                world_view, full_proj, campos, width, height,
                                sh_degree, scale_modifier)
    packed = pack_entries(pre)
    finite = torch.isfinite(torch.cat(
        [getattr(pre, f).reshape(len(packed), -1) for f in _RECORD_FIELDS],
        dim=1)).all(dim=1)
    return (packed, pre.depth, pre.extent, pre.radii, pre.visible & finite,
            pre.rho2max)


def _sh_basis(deg: int, x, y, z) -> list:
    """The real SH basis of ``eval_sh`` up to ``deg`` as (N,) tensors,
    each formed as ``eval_sh`` forms its factor, so that Σ_k b_k·sh_k in
    order k is ``eval_sh``'s sum (k = 1, 3 enter there subtracted)."""
    b = [torch.full_like(x, C0)]
    if deg >= 1:
        b += [-(C1 * y), C1 * z, -(C1 * x)]
    if deg >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        b += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
              C2[3] * xz, C2[4] * (xx - yy)]
    if deg >= 3:
        b += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
              C3[2] * y * (4 * zz - xx - yy),
              C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
              C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
              C3[6] * x * (xx - 3 * yy)]
    if deg >= 4:
        b += [C4[0] * xy * (xx - yy), C4[1] * yz * (3 * xx - yy),
              C4[2] * xy * (7 * zz - 1), C4[3] * yz * (7 * zz - 3),
              C4[4] * (zz * (35 * zz - 30) + 3), C4[5] * xz * (7 * zz - 3),
              C4[6] * (xx - yy) * (7 * zz - 1), C4[7] * xz * (xx - 3 * yy),
              C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return b


def _sh_dir_grad(deg: int, x, y, z, w) -> list:
    """Σ_k w_k ∇b_k, the gradient of Σ_k w_k b_k(x, y, z) with respect
    to the direction, for the basis of ``_sh_basis`` up to ``deg``."""
    zero = torch.zeros_like(x)
    g = [zero, zero, zero]

    def acc(k, c, dx, dy, dz):
        t = c * w[k]
        g[0], g[1], g[2] = g[0] + t * dx, g[1] + t * dy, g[2] + t * dz

    if deg >= 1:
        acc(1, -C1, 0.0, 1.0, 0.0)
        acc(2, C1, 0.0, 0.0, 1.0)
        acc(3, -C1, 1.0, 0.0, 0.0)
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        acc(4, C2[0], y, x, 0.0)
        acc(5, C2[1], 0.0, z, y)
        acc(6, C2[2], -2.0 * x, -2.0 * y, 4.0 * z)
        acc(7, C2[3], z, 0.0, x)
        acc(8, C2[4], 2.0 * x, -2.0 * y, 0.0)
    if deg >= 3:
        xy, yz, xz = x * y, y * z, x * z
        acc(9, C3[0], 6.0 * xy, 3.0 * (xx - yy), 0.0)
        acc(10, C3[1], yz, xz, xy)
        acc(11, C3[2], -2.0 * xy, 4.0 * zz - xx - 3.0 * yy, 8.0 * yz)
        acc(12, C3[3], -6.0 * xz, -6.0 * yz, 6.0 * zz - 3.0 * xx - 3.0 * yy)
        acc(13, C3[4], 4.0 * zz - 3.0 * xx - yy, -2.0 * xy, 8.0 * xz)
        acc(14, C3[5], 2.0 * xz, -2.0 * yz, xx - yy)
        acc(15, C3[6], 3.0 * (xx - yy), -6.0 * xy, 0.0)
    if deg >= 4:
        xyz = xy * z
        z7m1, z7m3 = 7.0 * zz - 1.0, 7.0 * zz - 3.0
        acc(16, C4[0], y * (3.0 * xx - yy), x * (xx - 3.0 * yy), 0.0)
        acc(17, C4[1], 6.0 * xyz, 3.0 * z * (xx - yy), y * (3.0 * xx - yy))
        acc(18, C4[2], y * z7m1, x * z7m1, 14.0 * xyz)
        acc(19, C4[3], 0.0, z * z7m3, y * (21.0 * zz - 3.0))
        acc(20, C4[4], 0.0, 0.0, z * (140.0 * zz - 60.0))
        acc(21, C4[5], z * z7m3, 0.0, x * (21.0 * zz - 3.0))
        acc(22, C4[6], 2.0 * x * z7m1, -2.0 * y * z7m1, 14.0 * z * (xx - yy))
        acc(23, C4[7], z * (3.0 * xx - 3.0 * yy), -6.0 * xyz,
            x * (xx - 3.0 * yy))
        acc(24, C4[8], 4.0 * x * (xx - 3.0 * yy), 4.0 * y * (yy - 3.0 * xx),
            0.0)
    return g


def preprocess_bwd_reference(d_packed, xyz, scaling, rotation, opacity,
                             features_dc, features_rest, colors, noise,
                             screen_offsets, world_view, full_proj, campos,
                             width: int, height: int, sh_degree: int,
                             scale_modifier: float = 1.0):
    """Plain PyTorch version of ``preprocess_bwd`` (all nine gradients,
    None for an input that is None): the forward's intermediates
    recomputed, then the chain rule written out step by step in the order
    ``csrc/preprocess_bwd.cu`` computes it, one (N,) tensor per scalar of
    the kernel."""
    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    def add(*vs):
        return [sum(v[k] for v in vs) for k in range(3)]

    # the forward's intermediates
    x = [xyz[:, k] for k in range(3)]
    s0, s1 = torch.exp(scaling[:, 0]), torch.exp(scaling[:, 1])
    su, sv = s0 * scale_modifier, s1 * scale_modifier
    q = [rotation[:, k] for k in range(4)]
    qn = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    nrm = torch.clamp(qn, min=1e-12)
    qh = [qk / nrm for qk in q]
    R = quat_to_rotmat(torch.stack(qh, dim=-1))
    t_u = [R[:, i, 0] for i in range(3)]
    t_v = [R[:, i, 1] for i in range(3)]
    t_w = [R[:, i, 2] for i in range(3)]
    M = world_to_pix(full_proj, width, height)
    V = world_view
    U_ = [su * t for t in t_u]
    V_ = [sv * t for t in t_v]
    # column j of Tm: (row 0, row 1, row 2) = (U·M_j, V·M_j, xyz·M_j + M_3j)
    c = [[dot(U_, M[:3, j]), dot(V_, M[:3, j]),
          dot(x, M[:3, j]) + M[3, j]] for j in range(3)]
    c0, c1, c2 = c
    B, C = cross(c1, c2), cross(c2, c0)
    eta = (1.0, 1.0, -1.0)
    dd = c2[0] * c2[0] + c2[1] * c2[1] - c2[2] * c2[2]
    dd_ok = torch.abs(dd) > 1e-12
    ic = 1.0 / torch.where(dd_ok, dd, torch.ones_like(dd))
    cx = (c0[0] * c2[0] + c0[1] * c2[1] - c0[2] * c2[2]) * ic
    cy = (c1[0] * c2[0] + c1[1] * c2[1] - c1[2] * c2[2]) * ic
    pv = [dot(x, V[:3, j]) + V[3, j] for j in range(3)]
    nv = [dot(t_w, V[:3, j]) for j in range(3)]
    flip = torch.where(dot(pv, nv) < 0.0, 1.0, -1.0)
    A = cross(c0, c1)
    if screen_offsets is not None:
        off0, off1 = screen_offsets[:, 0], screen_offsets[:, 1]
        A = [A[k] - off0 * B[k] - off1 * C[k] for k in range(3)]
    o = torch.sigmoid(opacity)
    if colors is None:
        d = [x[k] - campos[k] for k in range(3)]
        r = torch.rsqrt(dot(d, d) + 1e-16)
        dv = [dk * r for dk in d]
        nk = (sh_degree + 1) ** 2
        sh = torch.cat([features_dc, features_rest], dim=1)
        b = _sh_basis(sh_degree, *dv)
        v = b[0][:, None] * sh[:, 0]
        for k in range(1, nk):
            v = v + b[k][:, None] * sh[:, k]
        rgb = torch.clamp(v + 0.5, min=0.0)
    else:
        rgb = colors
    # a row the forward zeroed: any value of its record not finite
    rec = torch.stack([*A, *B, *C, *c2, cx, cy, o[:, 0],
                       *[n * flip for n in nv]], dim=1)
    ok = torch.isfinite(rec).all(dim=1) & torch.isfinite(rgb).all(dim=1)
    if noise is not None:
        ok = ok & torch.isfinite(noise).all(dim=1)
    g = torch.where(ok[:, None], d_packed, torch.zeros_like(d_packed))
    gc = [g[:, k] for k in range(ENTRY_F)]
    gA, gB, gC, gc2 = gc[0:3], gc[3:6], gc[6:9], gc[9:12]
    gcx, gcy, go = gc[12], gc[13], gc[14]

    # the screen offsets: A = c0×c1 − off0·B − off1·C
    gBt, gCt, g_off = gB, gC, None
    if screen_offsets is not None:
        g_off = torch.stack([-dot(gA, B), -dot(gA, C)], dim=1)
        gBt = [gB[k] - off0 * gA[k] for k in range(3)]
        gCt = [gC[k] - off1 * gA[k] for k in range(3)]
    # the three crosses
    gc0 = add(cross(c1, gA), cross(gCt, c2))
    gc1 = add(cross(gA, c0), cross(c2, gBt))
    gc2 = add(gc2, cross(gBt, c1), cross(c0, gCt))
    # the centre: cx = <c0, η∘c2> / dd, cy = <c1, η∘c2> / dd, with
    # dd = <c2, η∘c2> where |dd| > 1e-12, else 1
    kx, ky = gcx * ic, gcy * ic
    tc = torch.where(dd_ok, 2.0 * (gcx * cx + gcy * cy) * ic,
                     torch.zeros_like(ic))
    for k in range(3):
        gc0[k] = gc0[k] + eta[k] * (kx * c2[k])
        gc1[k] = gc1[k] + eta[k] * (ky * c2[k])
        gc2[k] = gc2[k] + eta[k] * (kx * c0[k] + ky * c1[k] - tc * c2[k])
    # the rows of Tm
    gU = [gc0[0] * M[i, 0] + gc1[0] * M[i, 1] + gc2[0] * M[i, 2]
          for i in range(3)]
    gV = [gc0[1] * M[i, 0] + gc1[1] * M[i, 1] + gc2[1] * M[i, 2]
          for i in range(3)]
    gx = [gc0[2] * M[i, 0] + gc1[2] * M[i, 1] + gc2[2] * M[i, 2]
          for i in range(3)]
    # the scales
    g_scaling = torch.stack([dot(gU, t_u) * scale_modifier * s0,
                             dot(gV, t_v) * scale_modifier * s1], dim=1)
    # the normal: flip · (t_w @ world_view[:3, :3])
    gnv = [gc[18 + j] * flip for j in range(3)]
    gtw = [gnv[0] * V[i, 0] + gnv[1] * V[i, 1] + gnv[2] * V[i, 2]
           for i in range(3)]
    # the rotation matrix's columns su·t_u, sv·t_v, t_w → the unit quaternion
    G = [[su * gU[i], sv * gV[i], gtw[i]] for i in range(3)]
    w_, x_, y_, z_ = qh
    gqh = [
        2.0 * (-z_ * G[0][1] + y_ * G[0][2] + z_ * G[1][0] - x_ * G[1][2]
               - y_ * G[2][0] + x_ * G[2][1]),
        2.0 * (y_ * G[0][1] + z_ * G[0][2] + y_ * G[1][0] - w_ * G[1][2]
               + z_ * G[2][0] + w_ * G[2][1]) - 4.0 * x_ * (G[1][1] + G[2][2]),
        2.0 * (x_ * G[0][1] + w_ * G[0][2] + x_ * G[1][0] + z_ * G[1][2]
               - w_ * G[2][0] + z_ * G[2][1]) - 4.0 * y_ * (G[0][0] + G[2][2]),
        2.0 * (-w_ * G[0][1] + x_ * G[0][2] + w_ * G[1][0] + y_ * G[1][2]
               + x_ * G[2][0] + y_ * G[2][1]) - 4.0 * z_ * (G[0][0] + G[1][1])]
    # the normalisation q / max(|q|, 1e-12)
    proj = torch.where(qn >= 1e-12, sum(a * b for a, b in zip(gqh, qh)),
                       torch.zeros_like(qn))
    g_rot = torch.stack([(gk - hk * proj) / nrm for gk, hk in zip(gqh, qh)],
                        dim=1)
    # the opacity's sigmoid
    g_opacity = go[:, None] * o * (1.0 - o)
    # the colour
    g_dc = g_rest = g_colors = None
    grgb = g[:, 15:18]
    if colors is not None:
        g_colors = grgb
    else:
        gv = torch.where(v + 0.5 >= 0.0, grgb, torch.zeros_like(grgb))
        g_sh = torch.zeros((xyz.shape[0], sh.shape[1], 3), dtype=xyz.dtype,
                           device=xyz.device)
        for k in range(nk):
            g_sh[:, k] = b[k][:, None] * gv
        w = [dot([gv[:, 0], gv[:, 1], gv[:, 2]],
                 [sh[:, k, 0], sh[:, k, 1], sh[:, k, 2]]) for k in range(nk)]
        gdir = _sh_dir_grad(sh_degree, *dv, w)
        gdd = dot(gdir, d) * (r * r * r)
        gx = [gx[k] + (r * gdir[k] - d[k] * gdd) for k in range(3)]
        g_dc, g_rest = g_sh[:, :1], g_sh[:, 1:]
    g_noise = g[:, 21:24] if noise is not None else None
    # a zeroed row's gradient is zero, also where an infinite input met
    # the zero cotangent above (0·inf)
    grads = (torch.stack(gx, dim=1), g_scaling, g_rot, g_opacity, g_dc,
             g_rest, g_colors, g_noise, g_off)
    return tuple(None if x is None else torch.where(
        ok.view((-1,) + (1,) * (x.dim() - 1)), x, torch.zeros_like(x))
        for x in grads)


class _Preprocess(torch.autograd.Function):
    """Raw parameters → (packed (N, 24), depth, extent, radii, visible,
    rho2max); differentiable in the record, through ``preprocess_bwd``."""

    @staticmethod
    def forward(ctx, xyz, scaling, rotation, opacity, features_dc,
                features_rest, colors, noise, screen_offsets, world_view,
                full_proj, campos, width, height, sh_degree, scale_modifier):
        inputs = (xyz, scaling, rotation, opacity, features_dc,
                  features_rest, colors, noise, screen_offsets, world_view,
                  full_proj, campos)
        out = preprocess_fwd(*inputs, width, height, sh_degree,
                             scale_modifier)
        ctx.save_for_backward(*inputs)
        ctx.meta = (width, height, sh_degree, scale_modifier)
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, d_packed, *_):
        with trace.span("render.prepare_bwd"):
            grads = preprocess_bwd(d_packed.contiguous(), *ctx.saved_tensors,
                                   *ctx.meta)
        return grads + (None,) * 7


def preprocess_packed(xyz, scaling, rotation, opacity, world_view, full_proj,
                      campos, width: int, height: int, *,
                      features_dc=None, features_rest=None,
                      sh_degree: int = 0, colors=None, noise=None,
                      screen_offsets=None,
                      scale_modifier: float = 1.0) -> PreprocessOut:
    """The render's preprocess, on the raw parameters (``preprocess_fwd``
    sets out the inputs), differentiable in each tensor input but the
    camera's. Returns a ``PreprocessOut`` whose differentiable fields are
    column views of ``packed``, K1's record: readers of a field get the
    record's value, a zeroed row's zeros included."""
    def c(x):
        return None if x is None else x.contiguous()

    packed, depth, extent, radii, visible, rho2max = _Preprocess.apply(
        c(xyz), c(scaling), c(rotation), c(opacity), c(features_dc),
        c(features_rest), c(colors), c(noise), c(screen_offsets),
        c(world_view), c(full_proj), c(campos), int(width), int(height),
        int(sh_degree), float(scale_modifier))
    return PreprocessOut(
        A=packed[:, 0:3], B=packed[:, 3:6], C=packed[:, 6:9],
        c2=packed[:, 9:12], center2d=packed[:, 12:14], opacity=packed[:, 14],
        rgb=packed[:, 15:18], normal=packed[:, 18:21], noise=packed[:, 21:24],
        depth=depth, extent=extent, radii=radii, visible=visible,
        rho2max=rho2max, packed=packed)
