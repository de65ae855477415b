"""Tile binning (plain torch, non-differentiable).

Counterpart of ``gs2d_tpu/ops/rasterize/binning.py::bin_gaussians``
without its XLA workarounds: torch has dynamic shapes, so there are no
capacities, no overflow flag, no chunk padding and no hand-rolled scans
or searches. The contract is the same per-tile list of Gaussians in
front-to-back order:

1. stable argsort of Gaussians by view depth, culled ones keyed at +inf
   (the tie-break of ``oracle.py``);
2. each visible Gaussian's tile rectangle from its screen extents, by the
   clipped-floor formula of the JAX package;
3. one (gaussian, tile) pair per rectangle cell, expanded with
   ``repeat_interleave``, sorted by the unique int64 key
   ``tile·N + depth_rank``;
4. per-tile ranges from ``bincount``/``cumsum``.

It also returns what the backward's per-Gaussian reduction needs (the
counterpart of the JAX package's ``seg_end_d``/``inv_order``/``inv``): the
depth order, each Gaussian's pair count in that order, and the sort
permutation from slots back to expansion order, where each Gaussian's
pairs are contiguous.

The JAX package's conservative interval cull (``binning.py:413-521``)
is not ported yet: it only drops pairs whose alpha is below the cutoff
on every pixel of the tile, so images do not depend on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import TILE_H, TILE_W, cdiv


class BinningOut(NamedTuple):
    gid: torch.Tensor         # (P,) int32 Gaussian id per slot, tile-major
    tile_start: torch.Tensor  # (T,) int32 first slot of each tile
    tile_count: torch.Tensor  # (T,) int32 slots of each tile
    num_pairs: int            # P
    order: torch.Tensor       # (N,) int64 Gaussian ids front to back
    counts: torch.Tensor      # (N,) int64 pairs per Gaussian, depth order
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


def bin_gaussians(center2d: torch.Tensor, extent: torch.Tensor,
                  depth: torch.Tensor, visible: torch.Tensor,
                  width: int, height: int) -> BinningOut:
    """Bin Gaussians into per-tile depth-ordered slot lists."""
    dev = center2d.device
    N = center2d.shape[0]
    ntx = cdiv(width, TILE_W)
    T = ntx * cdiv(height, TILE_H)

    depth_key = torch.where(visible, depth,
                            torch.full_like(depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)        # front → back
    tx0, tx1, ty0, ty1 = tile_rects(center2d, extent, width, height)
    w = torch.clamp(tx1 - tx0, min=0)
    h = torch.clamp(ty1 - ty0, min=0)
    counts = torch.where(visible, w * h, torch.zeros_like(w))[order]

    P = int(counts.sum())
    gid_rep = torch.repeat_interleave(order, counts, output_size=P)
    rank_rep = torch.repeat_interleave(
        torch.arange(N, device=dev), counts, output_size=P)
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(P, device=dev) - torch.repeat_interleave(
        first, counts, output_size=P)                    # cell in the rect
    wg = w[gid_rep]
    tile = (ty0[gid_rep] + k // wg) * ntx + tx0[gid_rep] + k % wg

    _, perm = torch.sort(tile * N + rank_rep)
    gid = gid_rep[perm].to(torch.int32)
    tile_count = torch.bincount(tile, minlength=T)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    return BinningOut(gid=gid, tile_start=tile_start.to(torch.int32),
                      tile_count=tile_count.to(torch.int32), num_pairs=P,
                      order=order, counts=counts, perm=perm)
