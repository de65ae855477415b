"""Adaptive densification: statistics, clone / split / prune, opacity reset.

Counterpart of ``gs2d_tpu/models/densify.py`` (reference
``scene/gaussian_model.py:348-407``, ``train.py:127-135``) on tensors that
resize, as the reference's do; the JAX package's capacity slots, free-slot
ranks and scatters have no counterpart.

  * clone — screen-gradient ≥ threshold and max scale ≤ percent_dense ·
    extent: a copy of the Gaussian.
  * split — screen-gradient ≥ threshold and max scale above that: two
    children at xyz + R·(ε ⊙ (s_u, s_v, 0)), ε ~ N(0, 1), with scales
    divided by 1.6; the original is pruned.
  * prune — opacity < min_opacity, plus world size > 0.1 · extent when
    ``max_screen_size > 0``, plus split originals. The reference's
    screen-radius test stays dead, as gs2d_tpu/models/densify.py:63-69
    explains (densification_postfix zeroes max_radii2D before it is read).

The JAX package's documented deviations (``densify.py:19-22``) hold here
too: the prune criteria are evaluated on the pre-densify population, and
children whose opacity is below ``min_opacity`` are dropped at creation.
Row order: the survivors in their old order, then the clones by source
index, then two children per split source, in source order. Every row
selection of a parameter, an Adam moment or the split noise goes through
the row-gather kernel (``ops/gather.py``). Survivors keep their Adam
moments, new rows start from zero, and all statistics are zero afterwards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.gather import gather_rows
from ..ops.quat import normalize_quat, quat_to_rotmat
from ..train.optim import FIELDS, AdamState
from ..utils import trace
from .gaussians import GaussianParams, GaussianState

# log(1.6) rounded to float32, the constant the JAX package's jitted
# densify subtracts (a float32 log of float32(1.6) lands one ulp higher)
LOG_1_6 = float(np.float32(math.log(1.6)))


def add_densification_stats(state: GaussianState,
                            screen_grads: torch.Tensor,
                            radii: torch.Tensor,
                            width: int, height: int) -> GaussianState:
    """Accumulate per-Gaussian screen-gradient norms and max radii.

    ``screen_grads`` (N, 2) arrive in pixel units (the gradient of the
    zero screen offsets). The reference kernel's mean2D gradients are in
    the NDC half-extent convention (pixel gradient × W/2, H/2), and the
    2e-4 densify threshold is tuned for those units, so they are scaled
    first. A Gaussian with radius 0 was not visible and accumulates
    nothing."""
    vis = radii > 0
    trace.count("sync")                  # a copy from pageable host memory
    scale = torch.tensor([0.5 * width, 0.5 * height],
                         dtype=screen_grads.dtype, device=screen_grads.device)
    g = screen_grads * scale
    gnorm = torch.sqrt(torch.sum(g * g, dim=-1))
    return dataclasses.replace(
        state,
        max_radii2d=torch.where(
            vis, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
            state.max_radii2d),
        grad_accum=state.grad_accum + torch.where(vis, gnorm,
                                                  torch.zeros_like(gnorm)),
        denom=state.denom + vis.to(torch.float32),
    )


@dataclasses.dataclass(frozen=True)
class DensifyCounts:
    """What one ``densify_and_prune`` did: N after = N before − pruned +
    clone + 2·split − culled."""
    clone: int     # Gaussians cloned (before the creation-time cull)
    split: int     # Gaussians split, each into two children
    pruned: int    # originals removed, split originals included
    culled: int    # new rows dropped at creation for low opacity
    children: int  # split children kept (2·split less the culled ones)


def _take(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of an (N, ...) leaf through its (N, F) view."""
    flat = leaf.reshape(leaf.shape[0], -1).contiguous()
    return gather_rows(flat, idx).reshape((idx.shape[0],) + leaf.shape[1:])


@torch.no_grad()
def densify_and_prune(state: GaussianState, opt: AdamState,
                      grad_threshold: float, min_opacity: float,
                      extent: float, max_screen_size: float,
                      percent_dense: float, *,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
    """Clone, split and prune → (GaussianState, AdamState, DensifyCounts).

    The split noise ε is ``noise`` (2·n_split, 3) when given — row 2j and
    2j+1 for the two children of the j-th split source — else drawn from
    ``generator`` on the state's device. The thresholds are taken as
    float32 and combined in float32, as the JAX package's jitted call
    does."""
    p = state.params
    dev = p.xyz.device
    grads = state.grad_accum / torch.clamp(state.denom, min=1.0)
    grads = torch.where(state.denom > 0, grads, torch.zeros_like(grads))
    scales = torch.exp(p.scaling)
    max_scale = torch.amax(scales, dim=-1)
    opacity = torch.sigmoid(p.opacity[:, 0])

    f32 = np.float32
    min_op = float(f32(min_opacity))
    hot = grads >= float(f32(grad_threshold))
    small = max_scale <= float(f32(percent_dense) * f32(extent))
    clone = hot & small
    split = hot & ~small
    prune = opacity < min_op
    if max_screen_size > 0:
        prune = prune | (max_scale > float(f32(0.1) * f32(extent)))
    prune = prune | split
    born_ok = opacity >= min_op                # the creation-time cull

    n_clone = int(clone.sum())
    n_split = int(split.sum())
    keep_idx = torch.nonzero(~prune).flatten()
    clone_idx = torch.nonzero(clone & born_ok).flatten()
    split_idx = torch.nonzero(split & born_ok).flatten()
    rows = torch.cat([keep_idx, clone_idx, split_idx.repeat_interleave(2)])
    n_keep, n_rows = keep_idx.numel(), rows.numel()
    s0 = n_keep + clone_idx.numel()            # first split child

    if noise is None:
        if generator is None:
            raise ValueError("densify_and_prune needs a generator or noise")
        noise = torch.randn((2 * n_split, 3), generator=generator,
                            dtype=torch.float32, device=dev)
    elif tuple(noise.shape) != (2 * n_split, 3):
        raise ValueError(f"noise must be ({2 * n_split}, 3) for {n_split} "
                         f"split Gaussians, got {tuple(noise.shape)}")

    new = {f: _take(getattr(p, f), rows) for f in FIELDS}
    if n_rows > s0:
        # the children of the kept split sources: their rank among all
        # split sources picks their noise rows 2·rank and 2·rank + 1
        rank = torch.masked_select(torch.cumsum(split.to(torch.int64), 0) - 1,
                                   split & born_ok)
        noise_idx = (2 * rank[:, None]
                     + torch.arange(2, device=dev)[None]).flatten()
        eps = gather_rows(noise.to(torch.float32).contiguous(), noise_idx)
        s = torch.exp(new["scaling"][s0:])
        eps = eps * torch.cat([s, torch.zeros_like(s[:, :1])], dim=-1)
        R = quat_to_rotmat(normalize_quat(new["rotation"][s0:]))
        new["xyz"][s0:] = new["xyz"][s0:] + torch.sum(R * eps[:, None, :],
                                                      dim=-1)
        new["scaling"][s0:] = new["scaling"][s0:] - LOG_1_6

    def moments(tree: GaussianParams) -> GaussianParams:
        out = {}
        for f in FIELDS:
            leaf = getattr(tree, f)
            zeros = torch.zeros((n_rows - n_keep,) + leaf.shape[1:],
                                dtype=leaf.dtype, device=dev)
            out[f] = torch.cat([_take(leaf, keep_idx), zeros])
        return GaussianParams(**out)

    zeros = torch.zeros(n_rows, dtype=torch.float32, device=dev)
    new_state = GaussianState(params=GaussianParams(**new),
                              active_sh_degree=state.active_sh_degree,
                              max_radii2d=zeros, grad_accum=zeros.clone(),
                              denom=zeros.clone())
    new_opt = AdamState(mu=moments(opt.mu), nu=moments(opt.nu),
                        step=opt.step)
    counts = DensifyCounts(
        clone=n_clone, split=n_split, pruned=int(prune.sum()),
        culled=n_clone - clone_idx.numel()
        + 2 * (n_split - split_idx.numel()),
        children=2 * split_idx.numel())
    return new_state, new_opt, counts


@torch.no_grad()
def reset_opacity(state: GaussianState, opt: AdamState):
    """Clamp sigmoid(opacity) to ≤ 0.01 and zero its Adam moments
    (reference :209-212) → (GaussianState, AdamState)."""
    o = torch.clamp(torch.sigmoid(state.params.opacity), max=0.01)
    params = dataclasses.replace(state.params,
                                 opacity=torch.log(o / (1.0 - o)))
    opt = AdamState(
        mu=dataclasses.replace(opt.mu,
                               opacity=torch.zeros_like(opt.mu.opacity)),
        nu=dataclasses.replace(opt.nu,
                               opacity=torch.zeros_like(opt.nu.opacity)),
        step=opt.step)
    return dataclasses.replace(state, params=params), opt
