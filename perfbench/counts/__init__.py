"""Operations and bytes of the kernels and of a whole step, from the
splats' geometry.

Every count here describes the work that the inputs need, whatever
implements it: the composited (surfel, pixel) pairs of a view, which
``perfbench.reference.raster.composited_pairs`` finds from the surfels,
the camera and the compositing rules alone (never from the program's
slots, pairs or bins, so that a change to binning or to its interval
cull leaves the yardstick where it is), times the operations one such
pair costs; plus the per-surfel and per-pixel work around it. Bytes
are each input read once and each output written once.

Operations per composited pair, forward (K1), counted from the
compositing's equations: p = A + x·B + y·C 12; 1/p2 and (u, v) 3;
u² + v² 3; the low-pass distance 6; the minimum 1; exp(−ρ/2)·o and the
clamp 4; the intersection depth 4; the three acceptance tests 3; the
transmittance test and update 3; the weight 1; colour and normal 12;
depth 2; the distortion depth m 3; the distortion's prefix sums 12; the
median test 2: 71.

Backward (K2): the forward's geometry again up to the weight 34; the
gradient of the weight from colour 12, normal 12, depth 4, alpha 2 and
distortion 15; the transmittance's 2; through exp and the minimum 3;
through ρ to (u, v) 4, to p 6; into A, B and C 18; through the depth
9; opacity 2; colour 6 and normal 6; summing the surfel's 22 gradient
terms 22: 157.

Per surfel: the set-up (quaternion to matrix 42, the homography's rows
51, the three cross products 27, the two dual-conic boxes 70 and the
box 25, the view transform and the facing normal 36, degree-3 SH with
its basis 131, activations 8): 390 forward, twice that backward, for
the visible surfels, and the view-depth and frustum test, 30, for the
rest; Adam, 14 operations on each of a surfel's 58 parameters: 812.

Per pixel: the bridge (background, normal rotation, depth division,
the depth map's normals) 77 and the render CLI's clamp 3; the loss
(L1 9, SSIM's five 11-tap separable blurs of three channels 660 and its
map 45, the normal term 6) and the bridge, 797 forward and twice that
backward in training.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12      # one H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12    # its HBM3

K1_OPS_PER_PAIR = 71
K2_OPS_PER_PAIR = 157
SETUP_OPS_VISIBLE = 390
SETUP_OPS_CULLED = 30
ADAM_OPS_PER_SURFEL = 14 * 58
RENDER_OPS_PER_PIXEL = 80
TRAIN_OPS_PER_PIXEL = 3 * 797

FIELD_FLOATS = 21       # A, B, C, c2, centre, opacity, rgb, normal
FIELD_GRAD_FLOATS = 19  # the same without the centre
PIXEL_OUT_FLOATS = 10   # rgb, depth, alpha, normal, median, distortion


def k1(view: dict) -> dict:
    """K1's operations, bytes and least time (s) for one view, whose
    ``pairs``, ``visible`` surfels and ``pixels`` are given."""
    ops = K1_OPS_PER_PAIR * view["pairs"]
    nbytes = 4 * (FIELD_FLOATS * view["visible"]
                  + PIXEL_OUT_FLOATS * view["pixels"])
    return _bound(ops, nbytes)


def k2(view: dict) -> dict:
    """K2's: the fields and the forward's outputs and the image gradient
    read once, the fields' gradient written once."""
    ops = K2_OPS_PER_PAIR * view["pairs"]
    nbytes = 4 * ((FIELD_FLOATS + FIELD_GRAD_FLOATS) * view["visible"]
                  + 2 * PIXEL_OUT_FLOATS * view["pixels"])
    return _bound(ops, nbytes)


def render_ops(view: dict) -> float:
    """A rendered view's operations."""
    return (K1_OPS_PER_PAIR * view["pairs"]
            + SETUP_OPS_VISIBLE * view["visible"]
            + SETUP_OPS_CULLED * (view["surfels"] - view["visible"])
            + RENDER_OPS_PER_PIXEL * view["pixels"])


def train_ops(view: dict) -> float:
    """A training step's operations."""
    return ((K1_OPS_PER_PAIR + K2_OPS_PER_PAIR) * view["pairs"]
            + 3 * SETUP_OPS_VISIBLE * view["visible"]
            + SETUP_OPS_CULLED * (view["surfels"] - view["visible"])
            + ADAM_OPS_PER_SURFEL * view["surfels"]
            + TRAIN_OPS_PER_PIXEL * view["pixels"])


def _bound(ops: float, nbytes: float) -> dict:
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"ops": ops, "bytes": nbytes, "seconds": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
