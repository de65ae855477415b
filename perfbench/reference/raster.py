"""Plain PyTorch reference of 2D Gaussian Splatting's render, in blocks.

Written from the equations of the 2DGS paper and its CUDA rasterizer
(Huang et al., SIGGRAPH 2024, github.com/hbb1/2d-gaussian-splatting):
each surfel is a disc in its own (u, v) plane; a pixel's ray meets that
plane at the homogeneous point p = A + x·B + y·C, (u, v) = (p0, p1) / p2;
the Gaussian is evaluated at min(u² + v², 2·d²) (the screen-space
low-pass filter, without gradient), alpha = min(0.99, o·exp(−ρ/2)),
composited front to back while alpha ≥ 1/255 and the intersection depth
is past the near plane 0.2, until the transmittance would fall under
1e-4. The median depth is the intersection depth of the last surfel
composited while the transmittance in front of it is still above 0.5,
and 0 where there is none; its gradient goes to that surfel's depth
alone. A surfel composites only inside the 16 × 32 pixel tiles that its
screen-space box (the cutoff ellipse's bounding box) touches. The
distortion channel is Σ_{i<j} w_i w_j (m_i − m_j)² with
m = 100/99.8 · (1 − 0.2/z).

It imports nothing of the program: the cameras' matrices, the per-surfel
set-up, the tile lists and the compositing are all worked out here. The
compositing runs over 8 × 8 pixel cells, each with the surfels whose tile
rectangle holds it and, where the surfel's cutoff ellipse lies wholly in
front of the camera, whose box (which bounds that ellipse and the
low-pass disc) touches it: the box leaves out only pixels whose alpha is
under the cutoff. Cells are grouped into blocks of similar list
lengths, each padded to its longest list, so that one block's (cells ×
list × pixels) tensors fit in a fixed number of elements. It is differentiable:
``render`` with ``grad_out`` composites each block again under autograd
and pushes the image gradient back into the per-surfel fields.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

ALPHA_CLAMP = 0.99
ALPHA_CUTOFF = 1.0 / 255.0
T_EPS = 1e-4
NEAR = 0.2
FAR = 100.0
FILTER = 2.0            # rho2d = FILTER · (dx² + dy²)
CULL_MARGIN = 0.05      # added to the cutoff's rho bound for the box
SIGMA = 3.0             # the box's fallback: 3 sigma
M_SCALE = FAR / (FAR - NEAR)
TILE_H, TILE_W = 16, 32
CELL = 8                # the reference's own blocks of pixels
ZNEAR, ZFAR = 0.01, 100.0

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# channels of the compositing output
CH_RGB = slice(0, 3)
CH_DEPTH = 3            # Σ w·z
CH_ALPHA = 4            # 1 − final transmittance
CH_NORMAL = slice(5, 8)
CH_DIST = 8
CH_M1 = 9               # Σ w·m
CH_M2 = 10              # Σ w·m²
CH_MEDIAN = 11          # the median depth
NUM_CH = 12
# the per-surfel fields the compositing reads, in this order
F_A, F_B, F_C, F_C2 = slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)
F_CENTER, F_OPACITY = slice(12, 14), 14
F_RGB, F_NORMAL = slice(15, 18), slice(18, 21)
NUM_F = 21


class View(NamedTuple):
    """A camera as its rig states it: R (camera → world rotation, the
    columns are the camera's right, down and forward axes), t (world →
    camera translation) and the field of view."""
    R: np.ndarray
    t: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int


class Matrices(NamedTuple):
    world_view: torch.Tensor   # (4, 4), points as rows: p_view = p @ M
    full_proj: torch.Tensor    # (4, 4), p_clip = p @ M
    campos: torch.Tensor       # (3,)


def matrices(view: View, device, dtype=torch.float32) -> Matrices:
    """The view and projection matrices of the 3DGS/2DGS camera model
    (getWorld2View2, getProjectionMatrix with z_sign = 1), in float64
    and then rounded."""
    w2c = np.eye(4)
    w2c[:3, :3] = np.asarray(view.R, np.float64).T
    w2c[:3, 3] = np.asarray(view.t, np.float64)
    th, tw = math.tan(view.fovy / 2), math.tan(view.fovx / 2)
    top, right = th * ZNEAR, tw * ZNEAR
    P = np.zeros((4, 4))
    P[0, 0] = ZNEAR / right
    P[1, 1] = ZNEAR / top
    P[3, 2] = 1.0
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return Matrices(dev(w2c.T), dev((P @ w2c).T),
                    dev(np.linalg.inv(w2c)[:3, 3]))


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def sh_to_rgb(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Degree-3 real SH, sh (N, 16, 3) coefficient-major, dirs (N, 3)
    unit → rgb (N, 3), 0.5 added and clamped at 0."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    basis = [torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
             SH_C2[3] * xz, SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
             SH_C3[2] * y * (4 * zz - xx - yy),
             SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]
    b = torch.cat(basis, dim=1)                       # (N, 16)
    return torch.clamp(torch.einsum("nk,nkc->nc", b, sh) + 0.5, min=0.0)


class Surfels(NamedTuple):
    fields: torch.Tensor     # (N, NUM_F), differentiable
    depth: torch.Tensor      # (N,) view z of the centre
    extent: torch.Tensor     # (N, 2) half box in pixels
    visible: torch.Tensor    # (N,) bool
    ellipse: torch.Tensor    # (N,) bool: the cutoff disc wholly in front


def setup(params: dict, mats: Matrices, width: int, height: int
          ) -> Surfels:
    """Per-surfel set-up from the raw parameters (xyz, features_dc,
    features_rest, scaling (log), rotation (wxyz), opacity (logit)):
    the splat-to-pixel homography's columns, its intersection
    coefficients (A, B, C), the cutoff ellipse's box, the view-space
    normal facing the camera and the SH colour."""
    xyz = params["xyz"]
    dt = xyz.dtype
    scales = torch.exp(params["scaling"])
    opacity = torch.sigmoid(params["opacity"])[:, 0]
    R = quat_rotmat(params["rotation"])
    W, H = float(width), float(height)
    ndc2pix = torch.tensor([[W / 2, 0, 0, 0], [0, H / 2, 0, 0],
                            [0, 0, 1, 0], [(W - 1) / 2, (H - 1) / 2, 0, 1]],
                           dtype=dt, device=xyz.device)
    w2p = (mats.full_proj @ ndc2pix)[:, [0, 1, 3]]          # (4, 3)
    row_u = (scales[:, 0:1] * R[:, :, 0]) @ w2p[:3]          # (N, 3)
    row_v = (scales[:, 1:2] * R[:, :, 1]) @ w2p[:3]
    row_c = xyz @ w2p[:3] + w2p[3]
    c0 = torch.stack([row_u[:, 0], row_v[:, 0], row_c[:, 0]], -1)
    c1 = torch.stack([row_u[:, 1], row_v[:, 1], row_c[:, 1]], -1)
    c2 = torch.stack([row_u[:, 2], row_v[:, 2], row_c[:, 2]], -1)
    A = torch.linalg.cross(c0, c1, dim=-1)
    B = torch.linalg.cross(c1, c2, dim=-1)
    C = torch.linalg.cross(c2, c0, dim=-1)

    def dual_box(r2):
        """Centre and squared half sizes of the box around the image of
        the disc u² + v² ≤ r2 (its dual conic diag(1, 1, −1/r2))."""
        sgn = torch.stack([torch.ones_like(r2), torch.ones_like(r2),
                           -1.0 / r2], -1)
        d = torch.sum(c2 * c2 * sgn, -1)
        ok = torch.abs(d) > 1e-12
        f = sgn / torch.where(ok, d, torch.ones_like(d))[:, None]
        cx = torch.sum(f * c0 * c2, -1)
        cy = torch.sum(f * c1 * c2, -1)
        hx2 = cx * cx - torch.sum(f * c0 * c0, -1)
        hy2 = cy * cy - torch.sum(f * c1 * c1, -1)
        return cx, cy, torch.stack([hx2, hy2], -1), ok, d

    with torch.no_grad():
        cx, cy, half2, ok1, _ = dual_box(torch.ones_like(opacity))
        sigma_box = SIGMA * torch.sqrt(torch.clamp(half2, min=1e-4))
        rho_max = 2.0 * torch.log(torch.clamp(opacity, min=1e-12)
                                  / ALPHA_CUTOFF) + CULL_MARGIN
        cxr, cyr, half2r, okr, dr = dual_box(torch.clamp(rho_max, min=1e-6))
        good = okr & (half2r[:, 0] > 0) & (half2r[:, 1] > 0) \
            & torch.all(torch.isfinite(half2r), -1)
        er = torch.sqrt(torch.clamp(half2r, min=0.0))
        hx = torch.maximum(torch.abs(cxr + er[:, 0] - cx),
                           torch.abs(cx - (cxr - er[:, 0])))
        hy = torch.maximum(torch.abs(cyr + er[:, 1] - cy),
                           torch.abs(cy - (cyr - er[:, 1])))
        box = torch.where(good[:, None], torch.stack([hx, hy], -1),
                          sigma_box)
        lowpass = torch.sqrt(torch.clamp(rho_max, min=0.0) / FILTER)
        extent = torch.maximum(box, lowpass[:, None])
        # w(u, v) = u·c2_0 + v·c2_1 + c2_2 > 0 on the whole disc of radius
        # sqrt(rho_max): its image is an ellipse, inside the box
        ellipse = good & (dr < 0) & (c2[:, 2] > 0)
        p_view = xyz.detach() @ mats.world_view[:3, :3] \
            + mats.world_view[3, :3]
        depth = p_view[:, 2]
        visible = (depth > NEAR) & ok1 & (rho_max > 0) \
            & torch.all(torch.isfinite(extent), -1) \
            & (cx + extent[:, 0] >= 0) & (cx - extent[:, 0] <= W - 1) \
            & (cy + extent[:, 1] >= 0) & (cy - extent[:, 1] <= H - 1)
    center = torch.stack([cx, cy], -1)

    n_view = R[:, :, 2] @ mats.world_view[:3, :3]
    p_view = xyz @ mats.world_view[:3, :3] + mats.world_view[3, :3]
    facing = torch.where(torch.sum(p_view * n_view, -1) < 0, 1.0, -1.0)
    n_view = n_view * facing[:, None].to(dt)

    dirs = xyz - mats.campos
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    sh = torch.cat([params["features_dc"], params["features_rest"]], 1)
    rgb = sh_to_rgb(sh, dirs)

    fields = torch.cat([A, B, C, c2, center.to(dt), opacity[:, None], rgb,
                        n_view], -1)
    return Surfels(fields, depth, extent, visible, ellipse)


class Cells(NamedTuple):
    ids: torch.Tensor      # (P,) surfel of each (cell, surfel) pair
    start: torch.Tensor    # (K,) first pair of each cell
    count: torch.Tensor    # (K,) pairs of each cell
    ncx: int               # cells across


def cell_lists(s: Surfels, width: int, height: int) -> Cells:
    """Every visible surfel on every cell it may composite in, each
    cell's list front to back (ties by index). A surfel may composite in
    the tiles its box touches (⌊(c − e)/32⌋ … ⌊(c + e)/32⌋ across, the
    same with 16 down); within them, where its cutoff region is an
    ellipse, only in the cells its box (widened by a pixel) touches."""
    ncx, ncy = -(-width // CELL), -(-height // CELL)
    ntx, nty = -(-width // TILE_W), -(-height // TILE_H)
    n = s.depth.shape[0]
    dev = s.depth.device
    key = torch.where(s.visible, s.depth.float(),
                      torch.full_like(s.depth.float(), float("inf")))
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    c = s.fields[:, F_CENTER].detach().float()
    e = s.extent.float()

    def fl(v, hi):
        return torch.clamp(torch.floor(v), 0, hi).long()

    # the tile rectangle, in cells
    cx0 = fl((c[:, 0] - e[:, 0]) / TILE_W, ntx) * (TILE_W // CELL)
    cx1 = torch.clamp(fl(torch.floor((c[:, 0] + e[:, 0]) / TILE_W) + 1, ntx)
                      * (TILE_W // CELL), max=ncx)
    cy0 = fl((c[:, 1] - e[:, 1]) / TILE_H, nty) * (TILE_H // CELL)
    cy1 = torch.clamp(fl(torch.floor((c[:, 1] + e[:, 1]) / TILE_H) + 1, nty)
                      * (TILE_H // CELL), max=ncy)
    tight = s.ellipse
    cx0 = torch.where(tight, torch.maximum(
        cx0, fl((c[:, 0] - e[:, 0] - 1) / CELL, ncx)), cx0)
    cx1 = torch.where(tight, torch.minimum(
        cx1, fl(torch.floor((c[:, 0] + e[:, 0] + 1) / CELL) + 1, ncx)), cx1)
    cy0 = torch.where(tight, torch.maximum(
        cy0, fl((c[:, 1] - e[:, 1] - 1) / CELL, ncy)), cy0)
    cy1 = torch.where(tight, torch.minimum(
        cy1, fl(torch.floor((c[:, 1] + e[:, 1] + 1) / CELL) + 1, ncy)), cy1)
    nx = torch.clamp(cx1 - cx0, min=0)
    cnt = torch.where(s.visible, nx * torch.clamp(cy1 - cy0, min=0), 0)
    sid = torch.nonzero(cnt).squeeze(1)
    reps = cnt[sid]
    total = int(reps.sum())
    first = torch.cumsum(reps, 0) - reps
    owner = torch.repeat_interleave(torch.arange(sid.numel(), device=dev),
                                    reps, output_size=total)
    k = torch.arange(total, device=dev) - first[owner]
    g = sid[owner]
    cell = (cy0[g] + k // nx[g]) * ncx + cx0[g] + k % nx[g]
    del k, owner, first
    srt = torch.argsort(cell * n + rank[g])
    ids = g[srt]
    count = torch.bincount(cell, minlength=ncx * ncy)
    start = torch.cumsum(count, 0) - count
    return Cells(ids, start, count, ncx)


def _pixels(cells: torch.Tensor, ncx: int, width: int, height: int,
            stride: int):
    """Pixel coordinates (nc, npx) of the given cells: every pixel, or
    with ``stride`` > 1 the lattice x ≡ y ≡ 0 (mod stride)."""
    lx = torch.arange(0, CELL, stride, device=cells.device)
    lx, ly = lx.repeat(lx.numel()), lx.repeat_interleave(lx.numel())
    ix = (cells % ncx)[:, None] * CELL + lx[None]
    iy = (cells // ncx)[:, None] * CELL + ly[None]
    inside = (ix < width) & (iy < height)
    return ix, iy, inside


def _geometry(f: torch.Tensor, valid: torch.Tensor, ix, iy, inside):
    """One block's pairs: f (nc, L, NUM_F) fields in list order, valid
    (nc, L), pixels (nc, npx) → (ok, alpha, z), each (nc, L, npx): ok
    where the pair passes the cutoff and the near plane."""
    dt = f.dtype
    px = ix.to(dt)[:, None, :]
    py = iy.to(dt)[:, None, :]

    def col(k):
        return f[:, :, k:k + 1]

    p0 = col(0) + px * col(3) + py * col(6)
    p1 = col(1) + px * col(4) + py * col(7)
    p2 = col(2) + px * col(5) + py * col(8)
    p2_ok = torch.abs(p2) > 1e-12
    p2 = torch.where(p2_ok, p2, torch.ones_like(p2))
    u = p0 / p2
    v = p1 / p2
    del p0, p1, p2
    dx = (px - col(12)).detach()
    dy = (py - col(13)).detach()
    rho = torch.minimum(u * u + v * v, FILTER * (dx * dx + dy * dy))
    del dx, dy
    alpha = torch.clamp(col(14) * torch.exp(-0.5 * rho), max=ALPHA_CLAMP)
    del rho
    z = u * col(9) + v * col(10) + col(11)
    del u, v
    ok = valid[:, :, None] & inside[:, None, :] & p2_ok & (z >= NEAR) \
        & (alpha >= ALPHA_CUTOFF)
    return ok, alpha, z


def _median(z: torch.Tensor, live: torch.Tensor, t_before: torch.Tensor
            ) -> torch.Tensor:
    """The median depth of each pixel, (nc, npx): the depth ``z`` of the
    last live surfel whose transmittance in front is above 0.5, by a
    gather, so that its gradient reaches that surfel's depth alone; 0
    where there is none."""
    slot = torch.arange(z.shape[1], dtype=torch.int32,
                        device=z.device)[None, :, None]
    last = torch.amax(torch.where(live & (t_before > 0.5), slot, -1), dim=1)
    med = torch.gather(z, 1, last.clamp(min=0).long()[:, None, :])[:, 0]
    return torch.where(last >= 0, med, torch.zeros_like(med))


def _composite(f: torch.Tensor, valid: torch.Tensor, ix, iy, inside):
    """One block → (nc, NUM_CH, npx) channels."""
    ok, alpha, z = _geometry(f, valid, ix, iy, inside)
    a0 = torch.where(ok, alpha, torch.zeros_like(alpha))
    del alpha
    t_incl = torch.cumprod(1.0 - a0, dim=1)
    keep = t_incl >= T_EPS
    live = keep & ok
    a = torch.where(keep, a0, torch.zeros_like(a0))
    del a0
    t_before = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]],
                         dim=1)
    w = a * t_before
    del a
    t_final = torch.amin(torch.where(keep, t_incl, torch.ones_like(t_incl)),
                         dim=1)
    del t_incl, keep
    z = torch.where(live, z, torch.ones_like(z))
    out = [None] * NUM_CH
    out[CH_MEDIAN] = _median(z, live, t_before)
    del t_before
    rgb = torch.einsum("tlp,tlc->tcp", w, f[:, :, F_RGB])
    nrm = torch.einsum("tlp,tlc->tcp", w, f[:, :, F_NORMAL])
    out[CH_RGB] = list(rgb.unbind(1))
    out[CH_NORMAL] = list(nrm.unbind(1))
    out[CH_DEPTH] = torch.sum(w * z, 1)
    s0 = 1.0 - t_final
    out[CH_ALPHA] = s0
    m = M_SCALE * (1.0 - NEAR / z)
    del z
    wsum = torch.sum(w, 1)
    m1 = torch.sum(w * m, 1)
    dm = m - (m1 / torch.clamp(wsum, min=1e-30))[:, None, :]
    # Σ_{i<j} w_i w_j (m_i − m_j)² = S0 · Σ w (m − m̄)², m̄ = Σ w m / Σ w:
    # no cancellation, unlike S0·Σ w m² − (Σ w m)²
    out[CH_DIST] = s0 * torch.sum(w * dm * dm, 1)
    out[CH_M1] = m1
    out[CH_M2] = torch.sum(w * m * m, 1)
    return torch.stack(out, 1)


def count_composited(fields: torch.Tensor, cells: Cells, width: int,
                     height: int, *, stride: int = 1, block: int = 1 << 26,
                     seg: int = 256) -> int:
    """The composited (surfel, pixel) pairs, of the lattice pixels where
    ``stride`` > 1: front to back, ``seg`` list entries at a time, with
    each pixel's transmittance carried from one to the next; a cell
    drops out once its list is spent or every pixel's transmittance is
    under 1e-4."""
    dev = fields.device
    with torch.no_grad():
        npx = (CELL // stride) ** 2
        K = cells.count.numel()
        t_in = torch.ones((K, npx), dtype=fields.dtype, device=dev)
        pairs = torch.zeros((), dtype=torch.long, device=dev)
        active = torch.nonzero(cells.count > 0).squeeze(1)
        lane = torch.arange(seg, device=dev)
        r = 0
        per = max(1, block // (seg * npx))
        while active.numel():
            for j in range(0, active.numel(), per):
                cl = active[j:j + per]
                pos = r + lane
                valid = pos[None] < cells.count[cl][:, None]
                idx = torch.where(valid, cells.start[cl][:, None] + pos[None],
                                  0)
                ix, iy, inside = _pixels(cl, cells.ncx, width, height,
                                         stride)
                ok, alpha, _ = _geometry(fields[cells.ids[idx]], valid, ix,
                                         iy, inside)
                a0 = torch.where(ok, alpha, torch.zeros_like(alpha))
                t = t_in[cl][:, None, :] * torch.cumprod(1.0 - a0, dim=1)
                pairs += (ok & (t >= T_EPS)).sum()
                t_in[cl] = t[:, -1]
            r += seg
            more = (cells.count[active] > r) \
                & (t_in[active] >= T_EPS).any(1)
            active = active[more]
    return int(pairs)


def composite(fields: torch.Tensor, cells: Cells, width: int, height: int,
              *, grad_out: Optional[torch.Tensor] = None,
              block: int = 1 << 26):
    """Composite every cell.

    Returns the image (NUM_CH, H, W). With ``grad_out`` (NUM_CH, H, W)
    each block is composited under autograd and the image gradient is
    pushed into ``fields`` (which must require grad) instead, and the
    result is None."""
    dev = fields.device
    order = torch.argsort(cells.count, descending=True)
    counts = cells.count[order].tolist()
    npx = CELL * CELL
    img = None
    if grad_out is None:
        img = torch.zeros((NUM_CH, height, width), dtype=fields.dtype,
                          device=dev)
    i = 0
    K = len(counts)
    while i < K and counts[i] > 0:
        L = counts[i]
        nc = max(1, min(K - i, block // max(1, L * npx)))
        cl = order[i:i + nc]
        i += nc
        lane = torch.arange(L, device=dev)
        valid = lane[None] < cells.count[cl][:, None]
        idx = torch.where(valid, cells.start[cl][:, None] + lane[None], 0)
        sid = cells.ids[idx]
        ix, iy, inside = _pixels(cl, cells.ncx, width, height, 1)
        if grad_out is not None:
            with torch.enable_grad():
                out = _composite(fields[sid], valid, ix, iy, inside)
                g = grad_out[:, iy.clamp(max=height - 1),
                             ix.clamp(max=width - 1)].permute(1, 0, 2)
                g = torch.where(inside[:, None, :], g, torch.zeros_like(g))
                torch.autograd.backward(out, g)
        else:
            with torch.no_grad():
                out = _composite(fields[sid], valid, ix, iy, inside)
            img[:, iy[inside], ix[inside]] = out.permute(1, 0, 2)[:, inside]
    return img


def bridge(ch: torch.Tensor, mats: Matrices, width: int, height: int,
           bg: torch.Tensor, depth_ratio: float = 0.0) -> dict:
    """Compositing channels → the renderer's outputs: rgb over the
    background, alpha, the world-space normal, the surface depth
    ((1 − r)·expected + r·median, r the depth ratio), the normal of the
    depth map (times alpha) and the distortion."""
    alpha = ch[CH_ALPHA:CH_ALPHA + 1]
    rgb = ch[CH_RGB] + (1.0 - alpha) * bg[:, None, None]
    Rv = mats.world_view[:3, :3]
    n_world = torch.einsum("chw,kc->khw", ch[CH_NORMAL], Rv)
    depth = torch.nan_to_num(ch[CH_DEPTH:CH_DEPTH + 1]
                             / torch.clamp(alpha, min=1e-12))
    depth = torch.where(alpha > 0, depth, torch.zeros_like(depth))
    if depth_ratio != 0.0:
        median = torch.nan_to_num(ch[CH_MEDIAN:CH_MEDIAN + 1])
        depth = depth * (1.0 - depth_ratio) + depth_ratio * median
    surf_normal = depth_normal(mats, depth[0], width, height) \
        .permute(2, 0, 1) * alpha.detach()
    return {"render": rgb, "rend_alpha": alpha, "rend_normal": n_world,
            "surf_depth": depth, "surf_normal": surf_normal,
            "rend_dist": ch[CH_DIST:CH_DIST + 1]}


def depth_normal(mats: Matrices, depth: torch.Tensor, width: int,
                 height: int) -> torch.Tensor:
    """World points of a depth map (rays through pixel x at x + 0.5·0,
    the 2DGS convention of W/2 as the principal point offset), then
    central-difference cross products, unit length, zero border."""
    dt = depth.dtype
    W, H = float(width), float(height)
    ndc2pix = torch.tensor([[W / 2, 0, 0], [0, H / 2, 0], [0, 0, 0],
                            [W / 2, H / 2, 1]], dtype=dt, device=depth.device)
    c2w = torch.linalg.inv(mats.world_view.T.double()).to(dt)
    proj = c2w.T @ mats.full_proj
    intr = (proj @ ndc2pix)[:3, :3].T
    gy, gx = torch.meshgrid(torch.arange(height, dtype=dt, device=depth.device),
                            torch.arange(width, dtype=dt, device=depth.device),
                            indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    rays = pts @ torch.linalg.inv(intr.double()).to(dt).T @ c2w[:3, :3].T
    p = depth[..., None] * rays + c2w[:3, 3]
    dx = p[2:, 1:-1] - p[:-2, 1:-1]
    dy = p[1:-1, 2:] - p[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n * torch.rsqrt(torch.sum(n * n, -1, keepdim=True) + 1e-20)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def render(params: dict, view: View, bg: torch.Tensor, *,
           depth_ratio: float = 0.0, block: int = 1 << 26) -> dict:
    """The renderer's outputs for ``view``, without gradient, with the
    median depth beside them."""
    with torch.no_grad():
        mats = matrices(view, params["xyz"].device, params["xyz"].dtype)
        s = setup(params, mats, view.width, view.height)
        cells = cell_lists(s, view.width, view.height)
        ch = composite(s.fields, cells, view.width, view.height,
                       block=block)
        out = bridge(ch, mats, view.width, view.height, bg, depth_ratio)
        out["depth_median"] = ch[CH_MEDIAN:CH_MEDIAN + 1]
        # the size of the two terms whose difference the distortion is
        out["dist_scale"] = ch[CH_ALPHA:CH_ALPHA + 1] * ch[CH_M2:CH_M2 + 1] \
            + ch[CH_M1:CH_M1 + 1] ** 2
        return out


def composited_pairs(params: dict, view: View, *, stride: int = 4,
                     block: int = 1 << 26):
    """(composited (surfel, pixel) pairs, visible surfels, pixels) of a
    view, from the geometry alone; with ``stride`` > 1 the pairs of the
    lattice pixels scaled up by the lattice's share of the pixels."""
    with torch.no_grad():
        mats = matrices(view, params["xyz"].device, params["xyz"].dtype)
        s = setup(params, mats, view.width, view.height)
        pairs = count_composited(s.fields,
                                 cell_lists(s, view.width, view.height),
                                 view.width, view.height, stride=stride,
                                 block=block)
        W, H = view.width, view.height
        lattice = (-(-W // stride)) * (-(-H // stride))
        return (pairs * (W * H) / lattice, int(s.visible.sum()), W * H)
