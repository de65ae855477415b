"""Densification statistics.

Counterpart of ``gs2d_tpu/models/densify.py::add_densification_stats``
(reference ``train.py:127-128``, ``gaussian_model.py:405-407``). Clone,
split, prune and the opacity reset come with the training loop.
"""

from __future__ import annotations

import dataclasses

import torch

from .gaussians import GaussianState


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
