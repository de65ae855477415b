"""Pixel-sharded rendering over the ranks of a process group.

Counterpart of ``gs2d_tpu/parallel/data_parallel.py``. The image splits
into horizontal row bands, one per rank, and each rank bins and
composites its own band (``rasterize_band``: K1 at the band's height, K2
in the backward, both evaluating p = A + x·B + y·C at the image's own
rows, so a band is the whole view's rows bit for bit; the JAX package
shifts A by y0·C instead, ``shift_viewport``, which rounds). The bands
are all-gathered into the whole image, on which every rank runs the
bridge and the losses; that costs one view of ground truth per rank and
needs no halo for SSIM's windows, the depth normals or the distortion
loss.

The gather's backward hands each rank the cotangent of its own rows and
nothing else: every rank computes the same whole-image loss, so summing
the ranks' cotangents, as a differentiable all-gather does, would make
each band's gradient W times too large. A rank's parameter gradients
then hold its band's share, and the training step sums them over the
ranks (``train/step.py``), the counterpart of the psum the JAX package's
GSPMD inserts.

Bands are TILE_H-aligned with a shorter last band (``multihost.band_rows``:
1080 rows over 4 ranks are 272/272/272/264). The JAX package asserts a
height divisible by n·TILE_H instead (``data_parallel.py:76-77``), which
1080 is not.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.rasterize.api import rasterize
from ..ops.rasterize.preprocess import PreprocessOut
from .multihost import band_rows, gather_bands, rank_and_size


def shift_viewport(pre: PreprocessOut, y0) -> PreprocessOut:
    """Re-target preprocessed Gaussians to a viewport starting at row y0.

    p(x, y_global) = A + x·B + y_global·C with y_global = y_local + y0
    ⇒ A' = A + y0·C; the conic center moves by −y0. Everything else is
    viewport-independent. This is how the JAX package renders a band; the
    port's bands (``rasterize_band``) evaluate the image's own rows
    instead, since folding y0·C into A rounds: at 1080 rows (y0 up to
    816) 18 pixels of the 1M-splat view left the sharding bar and K2's
    depth-coefficient gradients the gradient bar on an H100 (PERF.md
    §6)."""
    y0 = float(y0)
    shift = torch.tensor([0.0, y0], dtype=pre.center2d.dtype,
                         device=pre.center2d.device)
    return pre._replace(A=pre.A + y0 * pre.C,
                        center2d=pre.center2d - shift, packed=None)


def rasterize_band(pre: PreprocessOut, width: int, height: int, y0: int,
                   y1: int, cull: bool = True):
    """Rows [y0, y1) of the ``height``-row image (y0 a multiple of
    TILE_H) → ((NUM_OUT, y1 − y0, width), aux): ``rasterize`` at the
    band's height, with binning, the cull and K1/K2 in the image's own
    rows, so the band is those rows of the whole view bit for bit.
    ``height`` is the whole image's, for the check only."""
    if not 0 <= y0 < y1 <= height:
        raise ValueError(f"band [{y0}, {y1}) of a {height}-row image")
    return rasterize(pre, width, y1 - y0, cull=cull, row0=y0)


class _GatherBands(torch.autograd.Function):
    """Every rank's band → the whole image; backward: this rank's rows."""

    @staticmethod
    def forward(ctx, band, bands, rank, group):
        ctx.rows = bands[rank]
        return gather_bands(band, bands, group)

    @staticmethod
    def backward(ctx, g):
        y0, y1 = ctx.rows
        return g[:, y0:y1], None, None, None


def rasterize_sharded(pre: PreprocessOut, width: int, height: int,
                      group=None, cull: bool = True):
    """The whole image, each rank of ``group`` rasterizing its row band.

    ``pre`` holds every Gaussian's record on every rank (replicated, or
    gathered from shards by ``gaussian_parallel.gather_records``).
    Returns ((NUM_OUT, height, width) on every rank, aux): ``num_pairs``
    summed over the bands, ``max_band_pairs`` the largest band's (what a
    rank's slot lists must hold), and this rank's band's ``med_idx`` and
    ``n_contrib``."""
    rank, n = rank_and_size(group)
    bands = band_rows(height, n)
    y0, y1 = bands[rank]
    out, aux = rasterize_band(pre, width, height, y0, y1, cull)
    pairs = torch.tensor([aux["num_pairs"]], dtype=torch.int64,
                         device=out.device)
    if dist.is_initialized():
        out = _GatherBands.apply(out, bands, rank, group)
        every = [torch.empty_like(pairs) for _ in range(n)]
        dist.all_gather(every, pairs, group=group)
        pairs = torch.cat(every)
    return out, {"num_pairs": int(pairs.sum()),
                 "max_band_pairs": int(pairs.max()),
                 "med_idx": aux["med_idx"], "n_contrib": aux["n_contrib"]}


def all_reduce_sum(tensors, group=None):
    """Each tensor summed over the ranks of ``group``: one all-reduce of a
    flat buffer, whose result is the same on every rank."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [x.view_as(t) for x, t in zip(
        torch.split(flat, [t.numel() for t in tensors]), tensors)]


def _src(group):
    return 0 if group is None else dist.get_global_rank(group, 0)


def broadcast_from_main(tensors, group=None) -> None:
    """Overwrite each tensor, in place, with the first rank's of ``group``."""
    for t in tensors:
        dist.broadcast(t, _src(group), group=group)


def check_replicas(tensors, group=None, what: str = "state") -> None:
    """Raise unless every rank of ``group`` holds bit for bit the tensors
    the first rank holds: a digest (each tensor's size and the sum of its
    32-bit words) broadcast from the first rank and compared."""
    digest = torch.stack(
        [torch.tensor(t.numel(), device=t.device) for t in tensors]
        + [t.contiguous().view(torch.int32).to(torch.int64).sum()
           for t in tensors])
    ref = digest.clone()
    dist.broadcast(ref, _src(group), group=group)
    if not torch.equal(digest, ref):
        raise RuntimeError(f"rank {dist.get_rank()}: {what} differs from the "
                           "first rank's; the replicas diverged")
