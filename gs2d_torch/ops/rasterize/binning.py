"""Tile binning (plain torch, non-differentiable).

Counterpart of ``gs2d_tpu/ops/rasterize/binning.py::bin_gaussians``
without its XLA workarounds: torch has dynamic shapes, so there are no
capacities, no overflow flag, no chunk padding, no hand-rolled scans or
searches and no ``K_ENT`` strip tables. The contract is the same per-tile
list of Gaussians in front-to-back order:

1. stable argsort of Gaussians by view depth, culled ones keyed at +inf
   (the tie-break of ``oracle.py``);
2. each visible Gaussian's tile rectangle from its screen extents, by the
   clipped-floor formula of the JAX package;
3. one (gaussian, tile row) entry per row of the rectangle, expanded with
   ``repeat_interleave``; with ``cull_abc``/``rho2max`` each row keeps
   only the tiles of a conservative x-interval of the splat's support
   (``row_intervals``), otherwise the rectangle's full width;
4. one (gaussian, tile) pair per tile of each row's interval, sorted by
   the unique int64 key ``tile·N + depth_rank``;
5. per-tile ranges from ``bincount``/``cumsum``.

It also returns what the backward's per-Gaussian reduction needs (the
counterpart of the JAX package's ``seg_end_d``/``inv_order``/``inv``): the
depth order, each Gaussian's kept pair count in that order, and the sort
permutation from slots back to expansion order, where each Gaussian's
pairs are contiguous (rows top to bottom, tiles left to right).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .common import FILTER_INV_SQUARE, TILE_H, TILE_W, cdiv


class BinningOut(NamedTuple):
    gid: torch.Tensor         # (P,) int32 Gaussian id per slot, tile-major
    tile_start: torch.Tensor  # (T,) int32 first slot of each tile
    tile_count: torch.Tensor  # (T,) int32 slots of each tile
    num_pairs: int            # P, after the cull
    order: torch.Tensor       # (N,) int64 Gaussian ids front to back
    counts: torch.Tensor      # (N,) int64 kept pairs per Gaussian, depth order
    perm: torch.Tensor        # (P,) int64 slot → expansion index


def tile_rects(center2d: torch.Tensor, extent: torch.Tensor,
               width: int, height: int):
    """Half-open tile rectangles [tx0, tx1) × [ty0, ty1), int64, clipped
    to the tile grid. Clipping happens in float before the conversion, so
    huge or infinite extents clamp as the JAX package's saturating cast
    does."""
    ntx = cdiv(width, TILE_W)
    nty = cdiv(height, TILE_H)
    cx, cy = center2d[:, 0], center2d[:, 1]
    ex, ey = extent[:, 0], extent[:, 1]

    def fl(v, n):
        return torch.clamp(torch.floor(v), 0, n).to(torch.int64)

    tx0 = fl((cx - ex) / TILE_W, ntx)
    tx1 = fl(torch.floor((cx + ex) / TILE_W) + 1, ntx)
    ty0 = fl((cy - ey) / TILE_H, nty)
    ty1 = fl(torch.floor((cy + ey) / TILE_H) + 1, nty)
    return tx0, tx1, ty0, ty1


def _conic_constants(A, B, C, center2d, rho2max):
    """Per-Gaussian constants of the support's chord, in centred screen
    coordinates (u, v) = (x − cx, y − cy), as ``binning.py:426-457`` of
    the JAX package computes them, in the same float32 operations.

    A pixel composites iff Q = p0² + p1² − rho2max·p2² <= 0 with
    p = A + B·x + C·y, or the low-pass screen distance passes. Q's chord
    along u at height v is quu·u² + 2(quv·v + gu)·u + (qvv·v² + 2gv·v +
    qc) <= 0, whose discriminant in v is alf·v² + 2bet·v + gam. ``cond``
    gates on the conditioning of quu (the chord's denominator) and on
    finiteness; where it fails the row falls back to the full rectangle
    (``margf`` is then the −1 sentinel)."""
    cx0, cy0 = center2d[:, 0], center2d[:, 1]
    r2m = rho2max
    b0, b1, b2 = B[:, 0], B[:, 1], B[:, 2]
    e0, e1, e2 = C[:, 0], C[:, 1], C[:, 2]
    p0 = A[:, 0] + b0 * cx0 + e0 * cy0
    p1 = A[:, 1] + b1 * cx0 + e1 * cy0
    p2 = A[:, 2] + b2 * cx0 + e2 * cy0
    quu = b0 * b0 + b1 * b1 - r2m * b2 * b2
    qvv = e0 * e0 + e1 * e1 - r2m * e2 * e2
    quv = b0 * e0 + b1 * e1 - r2m * b2 * e2
    gu = p0 * b0 + p1 * b1 - r2m * p2 * b2
    gv = p0 * e0 + p1 * e1 - r2m * p2 * e2
    qc = p0 * p0 + p1 * p1 - r2m * p2 * p2
    alf = quv * quv - quu * qvv
    bet = quv * gu - quu * gv
    gam = gu * gu - quu * qc
    mag_uu = b0 * b0 + b1 * b1 + r2m * b2 * b2
    finite_all = torch.isfinite(quu + quv + gu + alf + bet + gam
                                + cx0 + cy0 + r2m)
    cond = (quu > 1e-4 * mag_uu) & finite_all
    quu_safe = torch.where(cond, quu, 1.0)
    margf = torch.where(cond, 1e-3 + 64.0 * 1.2e-7 * mag_uu / quu_safe,
                        -1.0)
    # First-order bounds on the float32 rounding of alf, bet and gam, which
    # the JAX package does not have: its inflation is relative to |alf|,
    # |bet|, |gam| themselves, but these are differences of products that
    # cancel. For a splat seen nearly edge-on quv² ≈ quu·qvv (float32 gives
    # alf = −32 where it is −3.8), the discriminant comes out too concave,
    # and rows that composite are dropped. Each step's bound is 16 units
    # of float32 rounding of the magnitudes that cancel there, plus the
    # bounds of its operands; ``row_intervals`` adds the three to the
    # discriminant. Evaluating the constants in float64 instead is not
    # enough: alf then has the sign of the float32 inputs' conic, but for
    # a splat seen exactly edge-on (alf is 0 but for rounding) the kernels
    # and the exact oracle evaluate p = A + B·x + C·y in float32, whose
    # rounding, not alf's, decides which tiles the support touches, and
    # float64 constants drop tiles that the oracle keeps
    # (tests/test_torch_cull.py, the edge_on scene).
    c = 16 * 2.0 ** -24
    ab = torch.abs
    pm0 = ab(A[:, 0]) + ab(b0 * cx0) + ab(e0 * cy0)
    pm1 = ab(A[:, 1]) + ab(b1 * cx0) + ab(e1 * cy0)
    pm2 = ab(A[:, 2]) + ab(b2 * cx0) + ab(e2 * cy0)
    mag_vv = e0 * e0 + e1 * e1 + r2m * e2 * e2
    quv_m = ab(b0 * e0) + ab(b1 * e1) + ab(r2m * b2 * e2)
    gu_e = 2 * c * (ab(b0) * pm0 + ab(b1) * pm1 + r2m * ab(b2) * pm2)
    gv_e = 2 * c * (ab(e0) * pm0 + ab(e1) * pm1 + r2m * ab(e2) * pm2)
    qc_e = 3 * c * (ab(p0) * pm0 + ab(p1) * pm1 + r2m * ab(p2) * pm2)
    alf_e = c * (quv * quv + ab(quu * qvv) + 2 * ab(quv) * quv_m
                 + ab(qvv) * mag_uu + ab(quu) * mag_vv)
    bet_e = c * (ab(quv * gu) + ab(quu * gv) + ab(gu) * quv_m
                 + ab(gv) * mag_uu) + ab(quv) * gu_e + ab(quu) * gv_e
    gam_e = c * (gu * gu + ab(quu * qc) + ab(qc) * mag_uu) \
        + 2 * ab(gu) * gu_e + ab(quu) * qc_e
    return torch.stack([alf, bet, gam, quv, gu, quu_safe, margf, r2m,
                        cx0, cy0, cond.to(alf.dtype), alf_e, bet_e, gam_e],
                       dim=1)


def row_intervals(cull_abc: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                  rho2max: torch.Tensor, center2d: torch.Tensor,
                  tx0: torch.Tensor, tx1: torch.Tensor, g_row: torch.Tensor,
                  ty_row: torch.Tensor, height: int):
    """Conservative tile interval [jx0, jx1) of each (gaussian, tile row)
    entry: Gaussian ``g_row`` on tile row ``ty_row``.

    The JAX package's strip entries (``binning.py:474-521``) with one row
    per entry, in the same float32 formulas and order: over the row's
    pixel-centre y-range [va, vb] the discriminant's maximum lies at the
    endpoints, plus the clamped vertex when it is concave (alf < 0); it is
    inflated by 1e-4 of the evaluation magnitudes and, unlike the JAX
    package, by the rounding bounds of alf, bet and gam at the row's
    largest |v| (``_conic_constants``), so the port's interval contains
    the JAX one. The chord is widened by the adaptive ``margf`` plus 2 px,
    united with the low-pass filter's circle chord (+1 px), and clipped
    into [tx0, tx1). A row whose Gaussian fails ``cond`` keeps [tx0, tx1).
    The clip happens in float before the integer cast, so a bound that
    overflowed to ±inf clamps to the rectangle's edge and a NaN bound
    widens the row to it."""
    k = _conic_constants(*cull_abc, center2d, rho2max)[g_row]
    alf, bet, gam, quv, gu, quu_safe, margf, r2m, cx0, cy0 = k[:, :10].T
    cond = k[:, 10] > 0
    alf_e, bet_e, gam_e = k[:, 11:].T
    ya = (ty_row * TILE_H).to(alf.dtype)
    yb = torch.clamp(ya + float(TILE_H - 1), max=height - 1.0)
    va = ya - cy0
    vb = yb - cy0

    def disc_at(v):
        d = (alf * v + 2.0 * bet) * v + gam
        return d + 1e-4 * (torch.abs(alf) * v * v
                           + 2.0 * torch.abs(bet) * torch.abs(v)
                           + torch.abs(gam))

    concave = alf < 0.0
    vhat = torch.clamp(-bet / torch.where(concave, alf, -1.0), va, vb)
    disc = torch.maximum(torch.maximum(disc_at(va), disc_at(vb)),
                         torch.where(concave, disc_at(vhat), -math.inf))
    vmax = torch.maximum(torch.abs(va), torch.abs(vb))
    disc = disc + ((alf_e * vmax + 2.0 * bet_e) * vmax + gam_e)
    cne = cond & (disc >= 0.0)
    half = torch.sqrt(torch.clamp(disc, min=0.0)) / quu_safe
    ca = -(quv * va + gu) / quu_safe
    cb = -(quv * vb + gu) / quu_safe
    ulo_c = torch.minimum(ca, cb) - half
    uhi_c = torch.maximum(ca, cb) + half
    marg = margf * (torch.abs(ulo_c) + torch.abs(uhi_c)) + 2.0
    ulo_c, uhi_c = ulo_c - marg, uhi_c + marg
    rf2 = r2m * (1.0 / FILTER_INV_SQUARE)
    dyf = torch.clamp(torch.maximum(va, -vb), min=0.0)
    fne = cond & (dyf * dyf <= rf2)
    fhalf = torch.sqrt(torch.clamp(rf2 - dyf * dyf, min=0.0)) + 1.0
    big = 1e9
    ulo = torch.minimum(torch.where(cne, ulo_c, big),
                        torch.where(fne, -fhalf, big))
    uhi = torch.maximum(torch.where(cne, uhi_c, -big),
                        torch.where(fne, fhalf, -big))
    lo, hi = tx0[g_row].to(alf.dtype), tx1[g_row].to(alf.dtype)
    x0 = torch.floor((cx0 + ulo) / TILE_W)
    x0 = torch.where(torch.isnan(x0), lo, torch.clamp(x0, lo, hi))
    x1 = torch.floor((cx0 + uhi) / TILE_W) + 1.0
    x1 = torch.where(torch.isnan(x1), hi, torch.clamp(x1, x0, hi))
    jx0 = torch.where(cond, x0, lo).to(torch.int64)
    jx1 = torch.where(cond, x1, hi).to(torch.int64)
    return jx0, jx1


def bin_gaussians(center2d: torch.Tensor, extent: torch.Tensor,
                  depth: torch.Tensor, visible: torch.Tensor,
                  width: int, height: int,
                  cull_abc: Optional[Tuple[torch.Tensor, ...]] = None,
                  rho2max: Optional[torch.Tensor] = None) -> BinningOut:
    """Bin Gaussians into per-tile depth-ordered slot lists.

    With ``cull_abc=(A, B, C)`` and ``rho2max`` (from preprocess, detached)
    each tile row of a Gaussian keeps only the tiles of its conservative
    support interval (``row_intervals``): the interval cull, which drops
    only pairs whose alpha is below the cutoff on every pixel of the tile
    (``tests/test_torch_cull.py``), so it changes no image. ``None`` bins
    every tile of each rectangle."""
    dev = center2d.device
    N = center2d.shape[0]
    ntx = cdiv(width, TILE_W)
    T = ntx * cdiv(height, TILE_H)

    depth_key = torch.where(visible, depth,
                            torch.full_like(depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)        # front → back
    tx0, tx1, ty0, ty1 = tile_rects(center2d, extent, width, height)
    rows = torch.where(visible, torch.clamp(ty1 - ty0, min=0), 0)[order]

    # level 1: (gaussian, tile row) entries, Gaussians in depth order
    R = int(rows.sum())
    rank_r = torch.repeat_interleave(torch.arange(N, device=dev), rows,
                                     output_size=R)
    g_r = order[rank_r]
    first_r = torch.cumsum(rows, 0) - rows
    ty_r = ty0[g_r] + torch.arange(R, device=dev) - first_r[rank_r]
    if cull_abc is None:
        jx0, jx1 = tx0[g_r], tx1[g_r]
    else:
        jx0, jx1 = row_intervals(cull_abc, rho2max, center2d, tx0, tx1,
                                 g_r, ty_r, height)
    w = torch.clamp(jx1 - jx0, min=0)                    # tiles per row
    counts = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(
        0, rank_r, w)

    # level 2: (gaussian, tile) pairs, each row's tiles left to right
    P = int(counts.sum())
    row_p = torch.repeat_interleave(w, output_size=P)
    first_p = torch.cumsum(w, 0) - w
    tile = ty_r[row_p] * ntx + jx0[row_p] + (
        torch.arange(P, device=dev) - first_p[row_p])
    rank_p = rank_r[row_p]

    _, perm = torch.sort(tile * N + rank_p)
    gid = order[rank_p[perm]].to(torch.int32)
    tile_count = torch.bincount(tile, minlength=T)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    return BinningOut(gid=gid, tile_start=tile_start.to(torch.int32),
                      tile_count=tile_count.to(torch.int32), num_pairs=P,
                      order=order, counts=counts, perm=perm)
