"""Renderer bridge: model state + camera → output dict.

Counterpart of ``gs2d_tpu/render/renderer.py`` with the output contract
of the reference bridge (``gaussian_renderer/__init__.py:114-225``): keys
render, rend_alpha, rend_normal (world space), rend_dist, surf_depth,
surf_normal, rend_noise (min-max normalized, detached), radii,
visibility_filter, plus the expected and median depths and the pair
count. There are no capacity keys: the port has no capacities.
``screen_offsets`` replaces the reference's retain_grad() means2D dummy:
pass zeros that require grad, and their gradient is the per-Gaussian
screen-space gradient the densification statistics use.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.gaussians import GaussianState, activated, sh_degree_mask
from ..ops.depth_utils import depth_to_normal
from ..ops.rasterize.api import rasterize
from ..ops.rasterize.preprocess import PreprocessOut, preprocess
from ..scene.cameras import Camera


def prepare(camera: Camera, state: GaussianState, *, max_sh_degree: int = 3,
            scaling_modifier: float = 1.0,
            override_color: Optional[torch.Tensor] = None,
            noise: Optional[torch.Tensor] = None,
            screen_offsets: Optional[torch.Tensor] = None) -> PreprocessOut:
    """Activate the state and run the per-Gaussian preprocess."""
    xyz, scales, quats, opacity, shs = activated(state.params)
    if override_color is None:
        kmask = sh_degree_mask(state.active_sh_degree, max_sh_degree,
                               device=xyz.device)
        shs = shs * kmask
    return preprocess(
        xyz, scales, quats, opacity,
        camera.world_view, camera.full_proj, camera.campos,
        camera.width, camera.height,
        sh_degree=max_sh_degree,
        shs=None if override_color is not None else shs,
        colors=override_color,
        scale_modifier=scaling_modifier,
        screen_offsets=screen_offsets,
        noise=noise,
    )


def bridge(camera: Camera, pre: PreprocessOut, out: torch.Tensor, aux: dict,
           bg: torch.Tensor, depth_ratio: float = 0.0) -> dict:
    """Rasterizer channels → the renderer's output dict."""
    alpha = out[4:5]
    rgb = out[0:3] + (1.0 - alpha) * bg[:, None, None]

    # view → world normals (reference :126-127)
    R = camera.world_view[:3, :3]          # row-vector W2V rotation block
    n_world = torch.einsum("chw,ck->khw", out[5:8], R.T)

    depth_expected = torch.nan_to_num(out[3:4] / torch.clamp(alpha, min=1e-12))
    depth_expected = torch.where(alpha > 0, depth_expected,
                                 torch.zeros_like(depth_expected))
    depth_median = torch.nan_to_num(out[8:9])
    surf_depth = (depth_expected * (1.0 - depth_ratio)
                  + depth_ratio * depth_median)

    surf_normal = depth_to_normal(camera, surf_depth).permute(2, 0, 1)
    surf_normal = surf_normal * alpha.detach()

    rend_noise = out[10:13].detach()
    lo = torch.amin(rend_noise)
    hi = torch.amax(rend_noise)
    rend_noise = (rend_noise - lo) / torch.clamp(hi - lo, min=1e-12)

    return {
        "render": rgb,
        "rend_alpha": alpha,
        "rend_normal": n_world,
        "rend_dist": out[9:10],
        "surf_depth": surf_depth,
        "surf_normal": surf_normal,
        "rend_noise": rend_noise,
        "depth_expected": depth_expected,
        "depth_median": depth_median,
        "radii": pre.radii,
        "visibility_filter": pre.radii > 0,
        "num_pairs": aux["num_pairs"],
    }


def render(camera: Camera, state: GaussianState, bg: torch.Tensor, *,
           max_sh_degree: int = 3, scaling_modifier: float = 1.0,
           override_color: Optional[torch.Tensor] = None,
           noise: Optional[torch.Tensor] = None,
           screen_offsets: Optional[torch.Tensor] = None,
           depth_ratio: float = 0.0, cull: bool = True,
           device="cuda") -> dict:
    """Render ``state`` from ``camera`` on ``device`` (default ``"cuda"``).

    Every tensor input must already lie on ``device``; a CPU render is
    asked for with ``device="cpu"`` and runs the kernels' plain versions.
    ``cull`` is the binning's interval cull (``rasterize``), on by
    default as in the JAX package.
    """
    device = torch.device(device)
    tensors = [("camera", camera.world_view), ("state", state.params.xyz),
               ("bg", bg), ("override_color", override_color),
               ("noise", noise), ("screen_offsets", screen_offsets)]
    for name, x in tensors:
        if x is not None and x.device.type != device.type:
            raise ValueError(f"render on {device}: {name} is on {x.device}")
    pre = prepare(camera, state, max_sh_degree=max_sh_degree,
                  scaling_modifier=scaling_modifier,
                  override_color=override_color, noise=noise,
                  screen_offsets=screen_offsets)
    out, aux = rasterize(pre, camera.width, camera.height, cull=cull)
    return bridge(camera, pre, out, aux, bg, depth_ratio)
