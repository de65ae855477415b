"""Sharding along the Gaussian axis on a 2-D (gauss, data) grid of ranks.

Counterpart of ``gs2d_tpu/parallel/gaussian_parallel.py`` ("phase B"):

* rank r of the grid's group sits at (g, d) = (r // data, r % data); the
  ranks at one g hold the same shard of the Gaussians (contiguous rows,
  ``shard_bounds``): its parameters, Adam moments and densification
  statistics, so per-rank parameter and optimizer memory falls by the
  gauss axis's size;
* the per-Gaussian preprocess runs on the shard; ``gather_records``
  all-gathers the records over the ranks at one d (``gauss_group``) before
  binning, padded to the largest shard, since shards may differ in size
  (the port has no fixed capacity);
* the image splits into one band per rank of the whole grid
  (``data_parallel.rasterize_sharded``), so the gauss axis also
  rasterizes pixels;
* in the backward, each rank's record gradients (its band's share) are
  reduce-scattered over ``gauss_group`` back to each record's owner, and
  the training step sums the parameter gradients over ``data_group`` (the
  ranks that hold the same shard): the transpose of the gather and the
  psum that GSPMD inserts in the JAX package;
* densification is row-wise, so each rank densifies its own shard.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.rasterize.preprocess import PreprocessOut
from .multihost import rank_and_size

GAUSS_AXIS = "gauss"

# the differentiable record fields, gathered as one (N, 24) table, and the
# binning's inputs, gathered as one (N, 6) float32 table
_DIFF = ("A", "B", "C", "c2", "center2d", "opacity", "rgb", "normal",
         "noise")


@dataclasses.dataclass(frozen=True)
class Grid:
    """A (gauss, data) grid over the ranks of ``group`` (``make_grid``)."""
    gauss: int
    data: int
    group: object         # every rank of the grid: one image band each
    gauss_group: object   # the ranks at this rank's d: one shard each
    data_group: object    # the ranks at this rank's g: the same shard

    def coords(self) -> Tuple[int, int]:
        rank = rank_and_size(self.group)[0]
        return rank // self.data, rank % self.data


def make_grid(gauss: int, data: int, group=None) -> Grid:
    """The (gauss, data) grid over ``group`` (the default group when None).
    Every rank of the default group must call it, in the same order, as
    ``torch.distributed.new_group`` requires."""
    rank, n = rank_and_size(group)
    if gauss * data != n:
        raise ValueError(f"a {gauss}x{data} grid needs {gauss * data} ranks, "
                         f"the group has {n}")
    ranks = (list(range(n)) if group is None
             else dist.get_process_group_ranks(group))
    g0, d0 = rank // data, rank % data
    gauss_group = data_group = None
    for d in range(data):
        pg = dist.new_group([ranks[g * data + d] for g in range(gauss)])
        if d == d0:
            gauss_group = pg
    for g in range(gauss):
        pg = dist.new_group([ranks[g * data + d] for d in range(data)])
        if g == g0:
            data_group = pg
    return Grid(gauss, data, dist.group.WORLD if group is None else group,
                gauss_group, data_group)


def has_gauss_axis(grid: Optional[Grid]) -> bool:
    return grid is not None and grid.gauss > 1


def check_capacity(num_gaussians: int, grid: Optional[Grid]) -> None:
    """Every shard of the gauss axis must hold a Gaussian."""
    if has_gauss_axis(grid) and num_gaussians < grid.gauss:
        raise ValueError(f"{num_gaussians} Gaussians cannot fill the "
                         f"{grid.gauss} shards of the gauss axis")


def shard_bounds(num_gaussians: int, shards: int) -> List[Tuple[int, int]]:
    """[r0, r1) of each shard: contiguous, sizes differing by at most 1."""
    q, r = divmod(num_gaussians, shards)
    starts = [i * q + min(i, r) for i in range(shards + 1)]
    return list(zip(starts[:-1], starts[1:]))


def _map_rows(state, opt, fn):
    """Apply ``fn`` to every (N, ...) tensor of a GaussianState and its
    AdamState → new (state, opt)."""
    def params(p):
        return dataclasses.replace(p, **{
            f.name: fn(getattr(p, f.name)) for f in dataclasses.fields(p)})

    state = dataclasses.replace(
        state, params=params(state.params),
        max_radii2d=fn(state.max_radii2d), grad_accum=fn(state.grad_accum),
        denom=fn(state.denom))
    opt = dataclasses.replace(opt, mu=params(opt.mu), nu=params(opt.nu))
    return state, opt


def shard_state(state, opt, grid: Grid):
    """This rank's shard of a (GaussianState, AdamState) that every rank
    holds whole: rows ``shard_bounds(N, gauss)[g]``."""
    n = state.params.xyz.shape[0]
    check_capacity(n, grid)
    r0, r1 = shard_bounds(n, grid.gauss)[grid.coords()[0]]
    return _map_rows(state, opt, lambda x: x[r0:r1].contiguous())


def _shard_sizes(rows: int, device, group) -> List[int]:
    n = rank_and_size(group)[1]
    mine = torch.tensor([rows], dtype=torch.int64, device=device)
    every = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(every, mine, group=group)
    return [int(x) for x in torch.cat(every).tolist()]


def gather_uneven(x: torch.Tensor, group, sizes=None) -> torch.Tensor:
    """Concatenate every rank's (n_i, ...) tensor in rank order."""
    if sizes is None:
        sizes = _shard_sizes(x.shape[0], x.device, group)
    padded = x.new_zeros((max(sizes),) + x.shape[1:])
    padded[:x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:k] for p, k in zip(parts, sizes)])


def unshard_state(state, opt, grid: Grid):
    """The whole (GaussianState, AdamState) on every rank, from the
    shards."""
    sizes = _shard_sizes(state.params.xyz.shape[0], state.params.xyz.device,
                         grid.gauss_group)
    return _map_rows(state, opt,
                     lambda x: gather_uneven(x, grid.gauss_group, sizes))


class _GatherRecords(torch.autograd.Function):
    """Shards' (n_i, F) records → every record; backward: the record
    gradients summed over the group and scattered to their owners."""

    @staticmethod
    def forward(ctx, local, sizes, rank, group):
        ctx.sizes, ctx.rank, ctx.group = sizes, rank, group
        return gather_uneven(local, group, sizes)

    @staticmethod
    def backward(ctx, g):
        sizes = ctx.sizes
        m = max(sizes)
        pieces = list(torch.split(g.contiguous(), sizes))
        padded = [torch.cat([p, p.new_zeros((m - p.shape[0],) + p.shape[1:])])
                  for p in pieces]
        mine = torch.empty_like(padded[0])
        dist.reduce_scatter(mine, padded, group=ctx.group)
        return mine[:sizes[ctx.rank]], None, None, None


def gather_records(pre: PreprocessOut, grid: Grid) -> PreprocessOut:
    """This rank's shard of preprocessed records → every Gaussian's, in
    shard order (the single-device order), on every rank of
    ``grid.gauss_group``; differentiable in the record fields."""
    group = grid.gauss_group
    rank = rank_and_size(group)[0]
    diff = [getattr(pre, f) for f in _DIFF]
    diff = [x[:, None] if x.dim() == 1 else x for x in diff]
    widths = [x.shape[1] for x in diff]
    local = torch.cat(diff, dim=1)
    sizes = _shard_sizes(local.shape[0], local.device, group)
    every = _GatherRecords.apply(local, sizes, rank, group)
    fields = dict(zip(_DIFF, torch.split(every, widths, dim=1)))
    fields["opacity"] = fields["opacity"][:, 0]
    aux = torch.cat([pre.depth[:, None], pre.extent, pre.rho2max[:, None],
                     pre.radii[:, None].to(torch.float32),
                     pre.visible[:, None].to(torch.float32)], dim=1)
    aux = gather_uneven(aux, group, sizes)
    return PreprocessOut(
        **fields, depth=aux[:, 0], extent=aux[:, 1:3], rho2max=aux[:, 3],
        radii=aux[:, 4].to(torch.int32), visible=aux[:, 5] > 0)
