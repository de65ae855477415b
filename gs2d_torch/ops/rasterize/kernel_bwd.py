"""Backward tile compositing: the CUDA kernel's wrapper and its plain version.

``rasterize_bwd`` replaces ``gs2d_tpu/ops/rasterize/kernel_bwd.py::
rasterize_bwd_pallas``: from the forward's records and outputs and the
cotangent of the outputs, the gradient of every slot's record, (P, 22)
float32 in the DFLD_* layout of ``common.py`` (the entry layout without
the two center columns, whose gradient is zero). Rows are in slot order,
tile-major as ``gid``; ``api.py`` reduces them to per-Gaussian gradients.

Closed form (``gs2d_tpu/ops/rasterize/kernel_bwd.py:1-37``), with
w_e = alpha_e T_e and the totals S0, M1, M2 of the forward's channels 4, 13
and 14::

    dalpha_e = T_e dw_e - (sum_{j>e} w_j dw_j + T_F dT_F) / (1 - alpha_e)

where the suffix sum is the grand total sum_ch g_ch out_ch (distortion
channel twice) minus the inclusive prefix. A pixel takes part up to its
``n_contrib`` from the forward; the median-depth gradient goes to the slot
equal to its ``med_idx``.

The kernel is ``gs2d_torch/csrc/rasterize_bwd.cu``. On a CPU tensor the
wrapper runs ``rasterize_bwd_reference``; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import cuda_build
from .common import (ALPHA_CLAMP, ALPHA_CUTOFF, DENTRY_F, FILTER_INV_SQUARE,
                     M_SCALE, NEAR_N, NUM_OUT, TILE_H, TILE_PX, TILE_W, cdiv)
from .kernel_fwd import _check_inputs


def _check_bwd_inputs(packed, gid, tile_start, tile_count, out, cot,
                      med_idx, n_contrib, width, height):
    T = _check_inputs(packed, gid, tile_start, tile_count, width, height)
    for name, x in (("out", out), ("cot", cot)):
        if x.dtype != torch.float32 or tuple(x.shape) != (T, NUM_OUT,
                                                          TILE_PX):
            raise ValueError(f"{name} must be ({T}, {NUM_OUT}, {TILE_PX}) "
                             f"float32, got {tuple(x.shape)} {x.dtype}")
    for name, x in (("med_idx", med_idx), ("n_contrib", n_contrib)):
        if x.dtype != torch.int32 or tuple(x.shape) != (T, TILE_PX):
            raise ValueError(f"{name} must be ({T}, {TILE_PX}) int32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    for name, x in (("out", out), ("cot", cot), ("med_idx", med_idx),
                    ("n_contrib", n_contrib)):
        if x.device != packed.device:
            raise ValueError(f"{name} is on {x.device}, packed on "
                             f"{packed.device}")
    return T


@functools.cache
def _kernel():
    """The C entry point of csrc/rasterize_bwd.cu, built at first use."""
    fn = cuda_build.load("rasterize_bwd").gs2d_rasterize_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 2)
    return fn


def rasterize_bwd(packed: torch.Tensor, gid: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  out: torch.Tensor, cot: torch.Tensor, med_idx: torch.Tensor,
                  n_contrib: torch.Tensor, width: int, height: int,
                  row0: int = 0):
    """Gradient of every slot's record.

    packed (N, 24), gid (P,), tile_start/tile_count (T,) and ``row0`` as
    for ``rasterize_fwd``; out (T, 15, 512) f32, med_idx and n_contrib
    (T, 512) int32 from it; cot (T, 15, 512) f32 the cotangent of out.
    Returns d_slots (P, 22) f32."""
    T = _check_bwd_inputs(packed, gid, tile_start, tile_count, out, cot,
                          med_idx, n_contrib, width, height)
    if packed.device.type == "cpu":
        return rasterize_bwd_reference(packed, gid, tile_start, tile_count,
                                       out, cot, med_idx, n_contrib, width,
                                       height, row0)
    if packed.device.type != "cuda":
        raise ValueError(f"rasterize_bwd runs on cuda or cpu tensors, got "
                         f"{packed.device}")
    if packed.shape[0] >= 2 ** 31 or gid.shape[0] >= 2 ** 31:
        raise ValueError("rasterize_bwd indexes records and slots as int32")
    args = [x.contiguous() for x in (packed, gid, tile_start, tile_count,
                                     out, cot, med_idx, n_contrib)]
    if args[0].data_ptr() % 16:
        args[0] = args[0].clone()   # the kernel stages rows in 16-byte copies
    fn = _kernel()
    dev = packed.device
    d_slots = torch.empty((gid.shape[0], DENTRY_F), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(x.data_ptr() for x in args), packed.shape[0],
                 gid.shape[0], T, width, height, row0, d_slots.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"rasterize_bwd kernel launch failed: CUDA error "
                           f"{err}")
    rasterize_bwd.launches += 1
    return d_slots


rasterize_bwd.launches = 0   # kernel launches since the last reset


def rasterize_bwd_reference(packed: torch.Tensor, gid: torch.Tensor,
                            tile_start: torch.Tensor, tile_count: torch.Tensor,
                            out: torch.Tensor, cot: torch.Tensor,
                            med_idx: torch.Tensor, n_contrib: torch.Tensor,
                            width: int, height: int, row0: int = 0,
                            tiles=None, return_composited: bool = False):
    """Plain PyTorch version of ``rasterize_bwd``, one tile at a time.

    Per tile the (records × pixels) terms are vectorized, in the kernel's
    operation order: transmittance is an inclusive ``cumprod`` over the
    record axis (the kernel's sequential product; records that do not
    composite multiply by exactly 1), the prefix of w·dw a ``cumsum``. The
    clamp's rule is its own (no gradient where opacity·G >= 0.99), not
    autograd's. ``tiles`` (a sequence of tile ids) restricts the result to
    the rows of those tiles' slot ranges, concatenated in that order. With
    ``return_composited`` it also returns the number of (record, pixel)
    pairs that carry a gradient (``live``), an int."""
    T = _check_bwd_inputs(packed, gid, tile_start, tile_count, out, cot,
                          med_idx, n_contrib, width, height)
    dev = packed.device
    ntx = cdiv(width, TILE_W)
    P = gid.shape[0]
    tiles = list(range(T)) if tiles is None else [int(t) for t in tiles]
    starts = tile_start.tolist()
    counts = tile_count.tolist()
    limits = n_contrib.amax(dim=1).tolist()

    lane = torch.arange(TILE_PX, device=dev)
    rows = []
    composited = torch.zeros((), dtype=torch.int64, device=dev)
    for t in tiles:
        s = starts[t]
        c = max(0, min(counts[t], P - s))
        d = torch.zeros((c, DENTRY_F), dtype=torch.float32, device=dev)
        rows.append(d)
        lim = min(c, limits[t])
        if lim <= 0:
            continue
        px = ((t % ntx) * TILE_W + lane % TILE_W).to(torch.float32)[None]
        py = (row0 + (t // ntx) * TILE_H + lane // TILE_W).to(
            torch.float32)[None]
        gi = gid[s:s + lim].long()
        ok_id = (gi >= 0) & (gi < packed.shape[0])
        e = torch.where(ok_id[:, None], packed[torch.where(ok_id, gi, 0)],
                        0.0)                                # (lim, 24)
        o = out[t]                                          # (15, 512)
        g = cot[t]

        def col(k):
            return e[:, k:k + 1]

        S0, M1, M2 = o[4], o[13], o[14]
        T_F = 1.0 - S0
        dT_F = -g[4]
        G_wdw = g[0] * o[0]
        for ch in (1, 2, 3, 5, 6, 7):
            G_wdw = G_wdw + g[ch] * o[ch]
        G_wdw = G_wdw + 2.0 * g[9] * o[9]
        for ch in (10, 11, 12, 13, 14):
            G_wdw = G_wdw + g[ch] * o[ch]

        # the forward's geometry (kernel_fwd.rasterize_fwd_reference)
        p0 = col(0) + px * col(3) + py * col(6)
        p1 = col(1) + px * col(4) + py * col(7)
        p2 = col(2) + px * col(5) + py * col(8)
        p2_ok = torch.abs(p2) > 1e-12
        p2s = torch.where(p2_ok, p2, torch.ones_like(p2))
        u = p0 / p2s
        v = p1 / p2s
        rho3d = u * u + v * v
        dx = px - col(12)
        dy = py - col(13)
        rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
        G = torch.exp(-0.5 * torch.minimum(rho3d, rho2d))
        raw = col(14) * G
        alpha = torch.clamp(raw, max=ALPHA_CLAMP)
        z = u * col(9) + v * col(10) + col(11)
        slot = torch.arange(lim, device=dev)[:, None]
        live = (slot < n_contrib[t][None]) & p2_ok & (z >= NEAR_N) \
            & (alpha >= ALPHA_CUTOFF)
        if return_composited:
            composited += live.sum()

        a = torch.where(live, alpha, torch.zeros_like(alpha))
        p_incl = torch.cumprod(1.0 - a, dim=0)
        T_before = torch.cat([torch.ones_like(p_incl[:1]), p_incl[:-1]])
        w = a * T_before
        zs = torch.where(live, z, torch.ones_like(z))
        m = M_SCALE * (1.0 - NEAR_N / zs)

        dw = col(15) * g[0]
        for k, ch in ((16, 1), (17, 2)):
            dw = dw + col(k) * g[ch]
        dw = dw + zs * g[3]
        for k, ch in ((18, 5), (19, 6), (20, 7), (21, 10), (22, 11),
                      (23, 12)):
            dw = dw + col(k) * g[ch]
        dw = dw + m * g[13]
        dw = dw + m * m * g[14]
        dw = dw + g[9] * (m * m * S0 + M2 - 2.0 * m * M1)
        dw = torch.where(live, dw, torch.zeros_like(dw))
        dm = w * g[13] + 2.0 * m * w * g[14] + g[9] * 2.0 * w * (m * S0 - M1)

        S_wdw = G_wdw - torch.cumsum(w * dw, dim=0)
        dalpha = T_before * dw - (S_wdw + T_F * dT_F) / (1.0 - a)
        dalpha = torch.where(live, dalpha, torch.zeros_like(dalpha))
        dz = w * g[3] + torch.where(slot == med_idx[t][None], g[8], 0.0)
        dz = dz + dm * (M_SCALE * NEAR_N / (zs * zs))
        dz = torch.where(live, dz, torch.zeros_like(dz))

        grad_ok = live & (raw < ALPHA_CLAMP)
        dopa = torch.where(grad_ok, dalpha * G, torch.zeros_like(G))
        dG = torch.where(grad_ok, dalpha * col(14), torch.zeros_like(G))
        drho = -0.5 * G * dG
        drho3d = torch.where(rho3d <= rho2d, drho, torch.zeros_like(drho))
        u_s = torch.where(live, u, torch.zeros_like(u))
        v_s = torch.where(live, v, torch.zeros_like(v))
        rp2_s = torch.where(live, 1.0 / p2s, torch.zeros_like(p2s))
        du = drho3d * 2.0 * u_s + dz * col(9)
        dv = drho3d * 2.0 * v_s + dz * col(10)
        dp0 = du * rp2_s
        dp1 = dv * rp2_s
        dp2 = -(du * u_s + dv * v_s) * rp2_s

        cols = [dp0, dp1, dp2, dp0 * px, dp1 * px, dp2 * px,
                dp0 * py, dp1 * py, dp2 * py, dz * u_s, dz * v_s, dz, dopa]
        cols += [w * g[ch] for ch in (0, 1, 2, 5, 6, 7, 10, 11, 12)]
        d[:lim] = torch.stack([x.sum(dim=1) for x in cols], dim=1)
    d_slots = torch.cat(rows) if rows else torch.zeros(
        (0, DENTRY_F), dtype=torch.float32, device=dev)
    if return_composited:
        return d_slots, int(composited)
    return d_slots
