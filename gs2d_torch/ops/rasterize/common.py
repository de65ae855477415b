"""Shared constants and layouts for the surfel rasterizer.

Copied from ``gs2d_tpu/ops/rasterize/common.py``: the numeric contract of
the reference CUDA rasterizer (0.99 alpha clamp, 1/255 alpha cutoff, 1e-4
transmittance early-out, 0.2/100.0 near/far for the distortion depth
remap, 3-sigma screen-space extent, inverse-square low-pass filter 2.0),
the 24-float entry record, the 22-float gradient row and the 15 output
channels. The CUDA kernels repeat these values in
``gs2d_torch/csrc/raster_common.cuh``; keep them in step. Also the plain
twins of the kernels' two skips (``skip_radius``, ``skip_pair``,
``row_may_hit``), which only the tests call.
"""

from __future__ import annotations

import torch

# Compositing guards
ALPHA_CLAMP = 0.99          # max per-splat alpha
ALPHA_CUTOFF = 1.0 / 255.0  # min alpha to composite
T_EPS = 1e-4                # stop when transmittance would fall below this
NEAR_N = 0.2                # near plane for per-pixel depth validity & m-map
FAR_N = 100.0               # far plane for the distortion depth remap
FILTER_INV_SQUARE = 2.0     # screen-space low-pass: rho2d = 2*d^2
SIGMA_CUTOFF = 3.0          # 3-sigma bounding extent
CULL_MARGIN = 0.05          # rho^2 safety band folded into rho2max

# Tile shape. Part of the contract: a splat composites only inside its
# binned tile rectangle (oracle.py), so the tile size changes images.
TILE_H = 16
TILE_W = 32
TILE_PX = TILE_H * TILE_W

# Entry record layout: p(x, y) = A + x*B + y*C is the homogeneous
# uv-plane intersection point of the pixel ray with the splat plane
# ((u, v) = (p0/p2, p1/p2)); c2 gives the camera-space depth of the
# intersection as u*c2[0] + v*c2[1] + c2[2].
FLD_A = slice(0, 3)
FLD_B = slice(3, 6)
FLD_C = slice(6, 9)
FLD_C2 = slice(9, 12)
FLD_CENTER = slice(12, 14)   # screen-space center of the projected ellipse
FLD_OPACITY = 14
FLD_RGB = slice(15, 18)
FLD_NORMAL = slice(18, 21)
FLD_NOISE = slice(21, 24)
ENTRY_F = 24

# Backward gradient-row layout (the backward kernel's per-slot rows): the
# entry layout minus the two center columns, which feed only the low-pass
# branch and so carry no gradient. The screen-space densification gradient
# flows through A instead (preprocess.py screen_offsets).
DFLD_A = slice(0, 3)
DFLD_B = slice(3, 6)
DFLD_C = slice(6, 9)
DFLD_C2 = slice(9, 12)
DFLD_OPACITY = 12
DFLD_RGB = slice(13, 16)
DFLD_NORMAL = slice(16, 19)
DFLD_NOISE = slice(19, 22)
DENTRY_F = 22

# Output channel layout of the tile kernel (the bridge exposes the first
# 13; channels 13-14 are totals the backward pass needs).
OUT_RGB = slice(0, 3)
OUT_DEPTH = 3        # alpha-weighted expected depth (sum w*z)
OUT_ALPHA = 4        # 1 - final transmittance
OUT_NORMAL = slice(5, 8)
OUT_MEDIAN = 8       # depth where transmittance crosses 0.5
OUT_DIST = 9         # depth-distortion accumulator
OUT_NOISE = slice(10, 13)
OUT_M1 = 13          # sum of w*m
OUT_M2 = 14          # sum of w*m^2
NUM_OUT = 15

M_SCALE = FAR_N / (FAR_N - NEAR_N)   # m = M_SCALE * (1 - NEAR_N / z)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def skip_radius(opacity):
    """r = 2·ln(opacity / ALPHA_CUTOFF) + CULL_MARGIN, per record, in float32:
    the largest rho at which opacity·exp(-rho/2) can still reach the alpha
    cutoff, widened by the margin (``csrc/raster_common.cuh``). Negative
    when the opacity is below the cutoff; NaN when it is negative or NaN."""
    opacity = torch.as_tensor(opacity, dtype=torch.float32)
    return 2.0 * torch.log(opacity * 255.0) + CULL_MARGIN


def skip_pair(p0, p1, p2, rho2d, r):
    """Plain twin of the kernels' ``skip_pair`` (``csrc/raster_common.cuh``):
    True where the (record, pixel) pair cannot composite and the kernels
    leave out its divisions and ``expf``. Rejects only if
    p0² + p1² > r·p2² (rho3d > r without dividing) and rho2d > r; a NaN
    anywhere, or |p2| ≤ 1e-12, gives False (the exact path decides). Not on
    any path: the CPU tests hold it against the exact alpha/z test."""
    q3 = p0 * p0 + p1 * p1
    return (torch.abs(p2) > 1e-12) & (q3 > r * (p2 * p2)) & (rho2d > r)


def row_may_hit(e, r, xa, py):
    """Plain twin of the kernels' ``row_may_hit`` (``csrc/raster_common.cuh``,
    which sets out why it is conservative), in the same float32 operations.

    e (R, 24) records, r (R,) their skip radii, xa the x of a warp row's
    first pixel, py its y. False where no pixel x in [xa, xa + 31] at py can
    composite the record, so the row's warp leaves the record out. Not on
    any path: the CPU tests hold it against the exact alpha test."""
    def f(k):
        return e[:, k]

    tiny = 2.0 ** -20
    xb = xa + float(TILE_W - 1)
    cx, cy = f(12), f(13)
    dxm = torch.where(cx < xa, xa - cx,
                      torch.where(cx > xb, cx - xb, torch.zeros_like(cx)))
    dy = py - cy
    rho2d_min = FILTER_INV_SQUARE * (dxm * dxm + dy * dy)
    pa2 = f(2) + xa * f(5) + py * f(8)
    pb2 = f(2) + xb * f(5) + py * f(8)
    err2 = tiny * (torch.abs(f(2)) + xb * torch.abs(f(5))
                   + py * torch.abs(f(8)))
    p2min = torch.fmin(torch.abs(pa2), torch.abs(pb2))
    pa0 = f(0) + xa * f(3) + py * f(6)
    pb0 = f(0) + xb * f(3) + py * f(6)
    pa1 = f(1) + xa * f(4) + py * f(7)
    pb1 = f(1) + xb * f(4) + py * f(7)
    err01 = tiny * (torch.abs(f(0)) + xb * torch.abs(f(3))
                    + py * torch.abs(f(6)) + torch.abs(f(1))
                    + xb * torch.abs(f(4)) + py * torch.abs(f(7)))
    ia, ib = 1.0 / pa2, 1.0 / pb2
    ua, va, ub, vb = pa0 * ia, pa1 * ia, pb0 * ib, pb1 * ib
    W = torch.fmax(torch.fmax(torch.abs(ua), torch.abs(va)),
                   torch.fmax(torch.abs(ub), torch.abs(vb)))
    iden = 1.0 / (p2min - err2)
    Wt = 1.5 * (W + err01 * iden) + tiny * W
    delta = (err01 + 2.0 * Wt * err2) * iden * 1.25 + tiny * Wt
    sx, sy = ub - ua, vb - va
    tc = torch.fmin(torch.fmax(-(ua * sx + va * sy) * (1.0 / (
        sx * sx + sy * sy)), torch.zeros_like(sx)), torch.ones_like(sx))
    qx, qy = ua + tc * sx, va + tc * sy
    D = torch.sqrt(qx * qx + qy * qy)
    lb = torch.fmax(D * (1.0 - tiny) - 2.0 ** -18 * W - 2.0 * delta,
                    torch.zeros_like(D))
    culled = (lb * lb * (1.0 - tiny) > r) & ((pa2 > 0) == (pb2 > 0)) \
        & (p2min > 4.0 * err2) & (rho2d_min > r) & (cx == cx)
    return ~culled
