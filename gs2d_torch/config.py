"""Training configuration.

Copy of ``gs2d_tpu/config.py`` (the reference's ``arguments/__init__.py:
47-131`` knob names and defaults), so a JAX configuration carries over
field for field. ``RuntimeParams`` keeps only the fields that mean
something without capacities; the saved ``cfg_args`` JSON is the JAX
package's format.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    render_items: tuple = ("RGB", "Alpha", "Normal", "Depth", "Edge",
                           "Curvature")


@dataclasses.dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    depth_ratio: float = 0.0
    debug: bool = False


@dataclasses.dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal: float = 0.05
    opacity_cull: float = 0.05
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002


@dataclasses.dataclass
class RuntimeParams:
    """Knobs of the port with no reference counterpart."""
    seed: int = 0                     # camera order and densify noise
    gt_cache_budget: int = 4 << 30    # device-resident ground truth (B)


def save_cfg_args(path: str, model: ModelParams, pipe: PipelineParams,
                  opt: OptimizationParams) -> None:
    """JSON config replay, in place of the reference's eval()-based
    cfg_args (``arguments/__init__.py:135-155``)."""
    with open(path, "w") as f:
        json.dump({
            "model": dataclasses.asdict(model),
            "pipeline": dataclasses.asdict(pipe),
            "optimization": dataclasses.asdict(opt),
        }, f, indent=2, default=list)


def load_cfg_args(path: str):
    with open(path) as f:
        d = json.load(f)
    m = ModelParams(**{**d["model"],
                       "render_items": tuple(d["model"]["render_items"])})
    return m, PipelineParams(**d["pipeline"]), OptimizationParams(
        **d["optimization"])
