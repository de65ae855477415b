"""Public rasterizer API: preprocess output → bin → compositing kernels → image.

Counterpart of ``gs2d_tpu/ops/rasterize/api.py`` without capacities: the
slot lists are as long as the scene needs. The autograd boundary
(``_Composite``, the counterpart of the JAX ``_core`` custom VJP) wraps
the tiled compositing only: its forward is K1 (``rasterize_fwd``), its
backward K2 (``rasterize_bwd``) followed by the deterministic reduction
of the per-slot gradient rows to per-Gaussian rows
(``reduce_slot_grads``). Everything around it (preprocess, packing,
untiling, the bridge) is plain torch under autograd. On CPU tensors the
kernels' plain versions run; on CUDA tensors the kernels, or an error.
"""

from __future__ import annotations

import torch

from .binning import BinningOut, bin_gaussians
from .common import DENTRY_F, NUM_OUT, TILE_H, TILE_W, cdiv
from .kernel_bwd import rasterize_bwd
from .kernel_fwd import rasterize_fwd
from .preprocess import PreprocessOut


def pack_entries(pre: PreprocessOut) -> torch.Tensor:
    """Per-Gaussian kernel record, layout per common.py FLD_*: (N, 24).

    A row with any non-finite value is zeroed: its p2 is then 0, so the
    kernels skip it and its gradient is zero
    (``gs2d_tpu/ops/rasterize/api.py:347-348``)."""
    packed = torch.cat(
        [pre.A, pre.B, pre.C, pre.c2, pre.center2d, pre.opacity[:, None],
         pre.rgb, pre.normal, pre.noise], dim=-1)
    finite = torch.isfinite(packed).all(dim=1, keepdim=True)
    return torch.where(finite, packed, torch.zeros_like(packed))


def untile(out_tiles: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(T, NUM_OUT, TILE_PX) tile-major → (NUM_OUT, height, width)."""
    ntx = cdiv(width, TILE_W)
    nty = cdiv(height, TILE_H)
    x = out_tiles.reshape(nty, ntx, NUM_OUT, TILE_H, TILE_W)
    x = x.permute(2, 0, 3, 1, 4).reshape(NUM_OUT, nty * TILE_H, ntx * TILE_W)
    return x[:, :height, :width]


def reduce_slot_grads(d_slots: torch.Tensor, bins: BinningOut,
                      num_gaussians: int) -> torch.Tensor:
    """(P, 22) per-slot gradient rows → (N, 24) per-Gaussian rows.

    Deterministic, without atomics (the counterpart of
    ``_segment_sum_rows_depth``, ``gs2d_tpu/ops/rasterize/api.py:136``):
    rows go back to expansion order through ``perm`` (unique indices), where
    each Gaussian's pairs are contiguous in depth order; a segment sum over
    ``counts`` gives one row per Gaussian, reordered through ``order``; the
    two center columns, which carry no gradient, are zero."""
    d_exp = torch.empty_like(d_slots).index_copy_(0, bins.perm, d_slots)
    d_depth = torch.segment_reduce(d_exp, "sum", lengths=bins.counts)
    d_g = torch.empty((num_gaussians, DENTRY_F), dtype=d_slots.dtype,
                      device=d_slots.device).index_copy_(0, bins.order,
                                                         d_depth)
    zero2 = torch.zeros((num_gaussians, 2), dtype=d_slots.dtype,
                        device=d_slots.device)
    return torch.cat([d_g[:, :12], zero2, d_g[:, 12:]], dim=1)


class _Composite(torch.autograd.Function):
    """packed records (N, 24) → tile images; backward through K2."""

    @staticmethod
    def forward(ctx, packed, bins: BinningOut, width: int, height: int):
        out, med_idx, n_contrib = rasterize_fwd(
            packed, bins.gid, bins.tile_start, bins.tile_count, width, height)
        ctx.save_for_backward(packed, out, med_idx, n_contrib)
        ctx.bins = bins
        ctx.size = (width, height)
        ctx.mark_non_differentiable(med_idx, n_contrib)
        return out, med_idx, n_contrib

    @staticmethod
    def backward(ctx, g_out, _g_med, _g_contrib):
        packed, out, med_idx, n_contrib = ctx.saved_tensors
        bins = ctx.bins
        d_slots = rasterize_bwd(packed, bins.gid, bins.tile_start,
                                bins.tile_count, out, g_out.contiguous(),
                                med_idx, n_contrib, *ctx.size)
        return (reduce_slot_grads(d_slots, bins, packed.shape[0]), None,
                None, None)


def bin_preprocessed(pre: PreprocessOut, width: int, height: int,
                     cull: bool = True) -> BinningOut:
    """``bin_gaussians`` on preprocess output, with the interval cull on
    (the JAX package's ``RasterizeConfig.cull`` default) unless ``cull``
    is False: the cull reads (A, B, C) and rho2max, detached."""
    cull_abc = tuple(x.detach() for x in (pre.A, pre.B, pre.C)) \
        if cull else None
    return bin_gaussians(pre.center2d, pre.extent, pre.depth, pre.visible,
                         width, height, cull_abc=cull_abc,
                         rho2max=pre.rho2max.detach() if cull else None)


def rasterize(pre: PreprocessOut, width: int, height: int,
              cull: bool = True):
    """Rasterize preprocessed Gaussians.

    Returns (out, aux): out is (NUM_OUT, height, width) float32 (rgb
    carries no background — callers composite ``rgb + (1-alpha)*bg``);
    aux holds ``num_pairs`` (after the cull) and the kernel's per-pixel
    ``med_idx`` and ``n_contrib``, tile-major (T, TILE_PX), whose slot
    indices are those of the culled lists. Differentiable with respect to
    every field of ``pre`` that the records carry. ``cull`` is the
    counterpart of ``RasterizeConfig.cull`` (``bin_preprocessed``); it
    changes which pairs the kernels see, not the image.
    """
    bins = bin_preprocessed(pre, width, height, cull)
    out_tiles, med_idx, n_contrib = _Composite.apply(
        pack_entries(pre), bins, width, height)
    return untile(out_tiles, width, height), {
        "num_pairs": bins.num_pairs, "med_idx": med_idx,
        "n_contrib": n_contrib}
