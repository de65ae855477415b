"""Shared constants and layouts for the surfel rasterizer.

Copied from ``gs2d_tpu/ops/rasterize/common.py``: the numeric contract of
the reference CUDA rasterizer (0.99 alpha clamp, 1/255 alpha cutoff, 1e-4
transmittance early-out, 0.2/100.0 near/far for the distortion depth
remap, 3-sigma screen-space extent, inverse-square low-pass filter 2.0),
the 24-float entry record, the 22-float gradient row and the 15 output
channels. The CUDA kernels (``gs2d_torch/csrc/rasterize_fwd.cu``,
``rasterize_bwd.cu``) repeat these values; keep them in step.
"""

from __future__ import annotations

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
