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

from ..models.gaussians import GaussianState
from ..ops.depth_utils import depth_to_normal
from ..ops.rasterize.api import rasterize
from ..ops.rasterize.preprocess import PreprocessOut, preprocess_packed
from ..parallel.data_parallel import rasterize_sharded
from ..parallel.gaussian_parallel import gather_records, has_gauss_axis
from ..scene.cameras import Camera
from ..utils import trace


def prepare(camera: Camera, state: GaussianState, *, max_sh_degree: int = 3,
            scaling_modifier: float = 1.0,
            override_color: Optional[torch.Tensor] = None,
            noise: Optional[torch.Tensor] = None,
            screen_offsets: Optional[torch.Tensor] = None) -> PreprocessOut:
    """The per-Gaussian preprocess of the raw state at its active SH
    degree (``preprocess_packed``: one kernel each way on the card); the
    result carries K1's record as ``packed``."""
    p = state.params
    sh = {}
    if override_color is None:
        K = p.features_rest.shape[1] + 1
        if K != (max_sh_degree + 1) ** 2:
            raise ValueError(f"the state holds {K} SH coefficients a "
                             f"surfel, max_sh_degree {max_sh_degree} "
                             f"{(max_sh_degree + 1) ** 2}")
        sh = {"features_dc": p.features_dc,
              "features_rest": p.features_rest,
              "sh_degree": min(state.active_sh_degree, max_sh_degree)}
    return preprocess_packed(
        p.xyz, p.scaling, p.rotation, p.opacity, camera.world_view,
        camera.full_proj, camera.campos, camera.width, camera.height,
        colors=override_color, noise=noise, screen_offsets=screen_offsets,
        scale_modifier=scaling_modifier, **sh)


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
           device="cuda", group=None, grid=None) -> dict:
    """Render ``state`` from ``camera`` on ``device`` (default ``"cuda"``).

    Every tensor input must already lie on ``device``; a CPU render is
    asked for with ``device="cpu"`` and runs the kernels' plain versions.
    ``cull`` is the binning's interval cull (``rasterize``), on by
    default as in the JAX package.

    With a process ``group`` each of its ranks rasterizes one row band
    and every rank gets the whole image (``parallel/data_parallel.py``);
    with a ``grid`` (``parallel/gaussian_parallel.py``) ``state`` is this
    rank's shard, whose records are gathered before binning, and the
    bands span the whole grid. The bridge runs on the whole image (its
    depth normals need every row); ``radii`` are the state's own.
    """
    device = torch.device(device)
    tensors = [("camera", camera.world_view), ("state", state.params.xyz),
               ("bg", bg), ("override_color", override_color),
               ("noise", noise), ("screen_offsets", screen_offsets)]
    for name, x in tensors:
        if x is not None and x.device.type != device.type:
            raise ValueError(f"render on {device}: {name} is on {x.device}")
    with trace.span("render"):
        with trace.span("render.prepare"):
            pre = prepare(camera, state, max_sh_degree=max_sh_degree,
                          scaling_modifier=scaling_modifier,
                          override_color=override_color, noise=noise,
                          screen_offsets=screen_offsets)
        records = pre
        if grid is not None:
            if group is not None:
                raise ValueError("render takes a group or a grid, not "
                                 "both")
            group = grid.group
            if has_gauss_axis(grid):
                records = gather_records(pre, grid)
        if group is None:
            out, aux = rasterize(pre, camera.width, camera.height,
                                 cull=cull)
        else:
            out, aux = rasterize_sharded(records, camera.width,
                                         camera.height, group, cull=cull)
        with trace.span("render.bridge"):
            return bridge(camera, pre, out, aux, bg, depth_ratio)
