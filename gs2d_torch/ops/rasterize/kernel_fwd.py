"""Forward tile compositing: the CUDA kernel's wrapper and its plain version.

``rasterize_fwd`` replaces ``gs2d_tpu/ops/rasterize/kernel_fwd.py::
rasterize_fwd_pallas`` and keeps its output layout: (T, NUM_OUT, TILE_PX)
float32 tile-major images, plus each pixel's median-contributor slot
(tile-local, -1 if none) as (T, TILE_PX) int32. It also returns
``n_contrib`` (T, TILE_PX) int32, one past the tile-local slot of the
pixel's last composited record (the reference CUDA's ``n_contrib``).

The kernel (``gs2d_torch/csrc/rasterize_fwd.cu``) reads each slot's
record straight from the packed (N, 24) table through ``gid``, so there
is no expansion gather and no blocked wire. On a CPU tensor the wrapper
runs ``rasterize_fwd_reference``; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import cuda_build
from .common import (ALPHA_CLAMP, ALPHA_CUTOFF, ENTRY_F, FILTER_INV_SQUARE,
                     M_SCALE, NEAR_N, NUM_OUT, OUT_ALPHA, OUT_DEPTH,
                     OUT_DIST, OUT_M1, OUT_M2, OUT_MEDIAN, OUT_NOISE,
                     OUT_NORMAL, OUT_RGB, T_EPS, TILE_H, TILE_PX, TILE_W,
                     cdiv)


def num_tiles(width: int, height: int) -> int:
    return cdiv(width, TILE_W) * cdiv(height, TILE_H)


def _check_inputs(packed, gid, tile_start, tile_count, width, height):
    if width <= 0 or height <= 0:
        raise ValueError(f"image size must be positive, got {width}x{height}")
    T = num_tiles(width, height)
    if packed.dtype != torch.float32 or packed.dim() != 2 \
            or packed.shape[1] != ENTRY_F:
        raise ValueError(f"packed must be (N, {ENTRY_F}) float32, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError(f"gid must be (P,) int32, got {tuple(gid.shape)} "
                         f"{gid.dtype}")
    for name, x in (("tile_start", tile_start), ("tile_count", tile_count)):
        if x.dtype != torch.int32 or tuple(x.shape) != (T,):
            raise ValueError(f"{name} must be ({T},) int32 for "
                             f"{width}x{height}, got {tuple(x.shape)} "
                             f"{x.dtype}")
    for name, x in (("packed", packed), ("gid", gid),
                    ("tile_start", tile_start), ("tile_count", tile_count)):
        if x.device != packed.device:
            raise ValueError(f"{name} is on {x.device}, packed on "
                             f"{packed.device}")
    return T


@functools.cache
def _kernel():
    """The C entry point of csrc/rasterize_fwd.cu, built at first use."""
    fn = cuda_build.load("rasterize_fwd").gs2d_rasterize_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 4)
    return fn


def rasterize_fwd(packed: torch.Tensor, gid: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  width: int, height: int):
    """Composite every tile's slot list front to back.

    packed (N, 24) f32 records; gid (P,) int32 slot → record; tile_start,
    tile_count (T,) int32 slot ranges. Returns (out (T, 15, 512) f32,
    med_idx (T, 512) int32, n_contrib (T, 512) int32)."""
    T = _check_inputs(packed, gid, tile_start, tile_count, width, height)
    if packed.device.type == "cpu":
        return rasterize_fwd_reference(packed, gid, tile_start, tile_count,
                                       width, height)
    if packed.device.type != "cuda":
        raise ValueError(f"rasterize_fwd runs on cuda or cpu tensors, got "
                         f"{packed.device}")
    if packed.shape[0] >= 2 ** 31 or gid.shape[0] >= 2 ** 31:
        raise ValueError("rasterize_fwd indexes records and slots as int32")
    packed, gid = packed.contiguous(), gid.contiguous()
    if packed.data_ptr() % 16:
        packed = packed.clone()   # the kernel stages rows in 16-byte copies
    tile_start, tile_count = tile_start.contiguous(), tile_count.contiguous()
    fn = _kernel()
    dev = packed.device
    out = torch.empty((T, NUM_OUT, TILE_PX), dtype=torch.float32, device=dev)
    med_idx = torch.empty((T, TILE_PX), dtype=torch.int32, device=dev)
    n_contrib = torch.empty((T, TILE_PX), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(packed.data_ptr(), gid.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), packed.shape[0], gid.shape[0], T,
                 width, height, out.data_ptr(), med_idx.data_ptr(),
                 n_contrib.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_fwd kernel launch failed: CUDA error "
                           f"{err}")
    rasterize_fwd.launches += 1
    return out, med_idx, n_contrib


rasterize_fwd.launches = 0   # kernel launches since the last reset


def rasterize_fwd_reference(packed: torch.Tensor, gid: torch.Tensor,
                            tile_start: torch.Tensor, tile_count: torch.Tensor,
                            width: int, height: int, tiles=None,
                            return_composited: bool = False):
    """Plain PyTorch version of ``rasterize_fwd``, one tile at a time.

    Per tile the (records × pixels) geometry is vectorized; transmittance
    is an inclusive ``cumprod`` over the record axis. The kept set is a
    prefix (the running product only falls), so the exclusive product of
    a kept record equals the kernel's sequential T, multiplied in the
    same order. ``tiles`` (a sequence of tile ids) restricts the output
    to those tiles, in that order. With ``return_composited`` a fourth
    value is the number of composited (record, pixel) pairs, an int."""
    T = _check_inputs(packed, gid, tile_start, tile_count, width, height)
    dev = packed.device
    ntx = cdiv(width, TILE_W)
    tiles = list(range(T)) if tiles is None else [int(t) for t in tiles]
    starts = tile_start.tolist()
    counts = tile_count.tolist()
    P = gid.shape[0]

    lane = torch.arange(TILE_PX, device=dev)
    out = torch.zeros((len(tiles), NUM_OUT, TILE_PX), dtype=torch.float32,
                      device=dev)
    med_idx = torch.full((len(tiles), TILE_PX), -1, dtype=torch.int32,
                         device=dev)
    n_contrib = torch.zeros((len(tiles), TILE_PX), dtype=torch.int32,
                            device=dev)
    composited = torch.zeros((), dtype=torch.int64, device=dev)
    for i, t in enumerate(tiles):
        s = starts[t]
        c = max(0, min(counts[t], P - s))
        if c == 0:
            continue
        ix = (t % ntx) * TILE_W + lane % TILE_W
        iy = (t // ntx) * TILE_H + lane // TILE_W
        inside = ((ix < width) & (iy < height))[None]
        px = ix.to(torch.float32)[None]
        py = iy.to(torch.float32)[None]
        g = gid[s:s + c].long()
        ok_id = (g >= 0) & (g < packed.shape[0])
        e = torch.where(ok_id[:, None], packed[torch.where(ok_id, g, 0)],
                        0.0)                                # (c, 24)

        def col(k):
            return e[:, k:k + 1]

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
        # the low-pass filter carries no gradient (as in the oracle)
        rho = torch.minimum(rho3d, rho2d.detach())
        alpha = torch.clamp(col(14) * torch.exp(-0.5 * rho), max=ALPHA_CLAMP)
        z = u * col(9) + v * col(10) + col(11)
        ok = inside & p2_ok & (z >= NEAR_N) & (alpha >= ALPHA_CUTOFF)
        a0 = torch.where(ok, alpha, torch.zeros_like(alpha))
        p_incl = torch.cumprod(1.0 - a0, dim=0)
        keep = p_incl >= T_EPS
        live = keep & ok
        a = torch.where(keep, a0, torch.zeros_like(a0))
        T_before = torch.cat([torch.ones_like(p_incl[:1]), p_incl[:-1]])
        w = a * T_before
        zs = torch.where(live, z, torch.ones_like(z))
        m = M_SCALE * (1.0 - NEAR_N / zs)
        T_final = torch.amin(torch.where(keep, p_incl,
                                         torch.ones_like(p_incl)), dim=0)
        s0 = 1.0 - T_final
        m1 = torch.sum(w * m, dim=0)
        m2 = torch.sum(w * m * m, dim=0)
        slot = torch.arange(c, device=dev)[:, None]
        last_med = torch.amax(torch.where(live & (T_before > 0.5), slot, -1),
                              dim=0)
        med = torch.gather(zs, 0, last_med.clamp(min=0)[None])[0]

        o = [None] * NUM_OUT
        o[OUT_RGB] = list((w.T @ e[:, 15:18]).T)
        o[OUT_DEPTH] = torch.sum(w * zs, dim=0)
        o[OUT_ALPHA] = s0
        o[OUT_NORMAL] = list((w.T @ e[:, 18:21]).T)
        o[OUT_MEDIAN] = torch.where(last_med >= 0, med, 0.0)
        o[OUT_DIST] = s0 * m2 - m1 * m1
        o[OUT_NOISE] = list((w.T @ e[:, 21:24]).T)
        o[OUT_M1] = m1
        o[OUT_M2] = m2
        out[i] = torch.stack(o)
        med_idx[i] = last_med.to(torch.int32)
        n_contrib[i] = torch.amax(torch.where(live, slot + 1, 0),
                                  dim=0).to(torch.int32)
        if return_composited:
            composited += live.sum()
    if return_composited:
        return out, med_idx, n_contrib, int(composited)
    return out, med_idx, n_contrib
