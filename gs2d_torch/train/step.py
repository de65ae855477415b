"""The training step.

Counterpart of ``gs2d_tpu/train/step.py``: render (K1), the losses on the
reference schedule (``train.py:54-140``), the backward (K2, the
per-Gaussian reduction, autograd through preprocess and SH), Adam and the
densification statistics::

    loss = (1 − λ_dssim)·L1 + λ_dssim·(1 − SSIM)
         + λ_dist·mean(dist)                (iteration > 3000)
         + λ_normal·mean(1 − n_rend·n_surf)  (iteration > 7000)

The screen-space densification gradient is the gradient of all-zeros
screen offsets (``preprocess.py``), in place of the reference's
retain_grad() dummy. The JAX step's capacities, overflow gate and mesh
have no counterpart: the port's slot lists are as long as the scene needs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import OptimizationParams
from ..models.densify import add_densification_stats
from ..models.gaussians import GaussianParams, GaussianState
from ..ops.ssim import l1_loss, ssim
from ..render.renderer import render
from ..scene.cameras import Camera
from ..utils.general import expon_lr
from .optim import FIELDS, AdamState, adam_step, make_lrs


@dataclasses.dataclass
class TrainState:
    gaussians: GaussianState
    opt: AdamState


def compute_losses(pkg: dict, gt_image: torch.Tensor, iteration: int,
                   opt_cfg: OptimizationParams):
    """The render's output dict → (total loss, the loss terms)."""
    image = pkg["render"]
    ll1 = l1_loss(image, gt_image)
    ssim_v = ssim(image, gt_image)
    base = ((1.0 - opt_cfg.lambda_dssim) * ll1
            + opt_cfg.lambda_dssim * (1.0 - ssim_v))
    lam_n = opt_cfg.lambda_normal if iteration > 7000 else 0.0
    lam_d = opt_cfg.lambda_dist if iteration > 3000 else 0.0
    normal_err = 1.0 - torch.sum(pkg["rend_normal"] * pkg["surf_normal"],
                                 dim=0)
    normal_loss = lam_n * torch.mean(normal_err)
    dist_loss = lam_d * torch.mean(pkg["rend_dist"])
    total = base + normal_loss + dist_loss
    return total, {"l1": ll1, "ssim": ssim_v, "loss": base,
                   "dist_loss": dist_loss, "normal_loss": normal_loss}


def loss_and_grads(state: GaussianState, camera: Camera,
                   gt_image: torch.Tensor, iteration: int, bg: torch.Tensor,
                   opt_cfg: OptimizationParams, *, max_sh_degree: int = 3,
                   depth_ratio: float = 0.0, cull: bool = True,
                   device="cuda"):
    """The step's loss and its gradients, at ``state.active_sh_degree``.

    Returns (total, terms, grads, screen_grads, pkg): the loss terms of
    ``compute_losses``, the gradient of every parameter field as a
    ``GaussianParams``, the (N, 2) pixel-unit gradient of the screen
    offsets, and the render's output dict."""
    leaves = {f: getattr(state.params, f).detach().requires_grad_()
              for f in FIELDS}
    offsets = torch.zeros((state.params.xyz.shape[0], 2),
                          dtype=torch.float32, device=state.params.xyz.device,
                          requires_grad=True)
    pkg = render(camera, dataclasses.replace(
        state, params=GaussianParams(**leaves)), bg,
        max_sh_degree=max_sh_degree, screen_offsets=offsets,
        depth_ratio=depth_ratio, cull=cull, device=device)
    total, terms = compute_losses(pkg, gt_image, iteration, opt_cfg)
    grads = torch.autograd.grad(total, list(leaves.values()) + [offsets])
    return (total.detach(), {k: v.detach() for k, v in terms.items()},
            GaussianParams(*grads[:-1]), grads[-1], pkg)


def apply_update(state: GaussianState, opt: AdamState, grads: GaussianParams,
                 screen_grads: torch.Tensor, radii: torch.Tensor,
                 camera: Camera, lrs: GaussianParams) -> TrainState:
    """Adam on every field, then the densification statistics."""
    params, opt = adam_step(state.params, grads, opt, lrs)
    state = dataclasses.replace(state, params=params)
    state = add_densification_stats(state, screen_grads, radii,
                                    camera.width, camera.height)
    return TrainState(gaussians=state, opt=opt)


def make_train_step(opt_cfg: OptimizationParams, *, max_sh_degree: int = 3,
                    spatial_lr_scale: float = 1.0, depth_ratio: float = 0.0,
                    cull: bool = True, device="cuda"):
    """Builds ``train_step(ts, camera, gt_image, iteration, bg,
    lr_iteration=None) -> (TrainState, metrics)`` on ``device`` (default
    ``"cuda"``); every tensor it is given must lie there. ``cull`` is the
    render's interval cull, on by default as in the JAX step."""
    device = torch.device(device)

    def lr_for(iteration: int) -> float:
        return expon_lr(iteration, opt_cfg.position_lr_init * spatial_lr_scale,
                        opt_cfg.position_lr_final * spatial_lr_scale,
                        lr_delay_mult=opt_cfg.position_lr_delay_mult,
                        max_steps=opt_cfg.position_lr_max_steps)

    def train_step(ts: TrainState, camera: Camera, gt_image: torch.Tensor,
                   iteration: int, bg: torch.Tensor, lr_iteration=None):
        # lr_iteration: a separate clock for the xyz LR (the IG2G fork
        # restarts it); every other schedule keeps the raw iteration
        for name, x in (("state", ts.gaussians.params.xyz),
                        ("camera", camera.world_view),
                        ("gt_image", gt_image), ("bg", bg)):
            if x.device.type != device.type:
                raise ValueError(f"train_step on {device}: {name} is on "
                                 f"{x.device}")
        iteration = int(iteration)
        # SH degree ramp: +1 every 1000 iterations (reference train.py:61-62)
        gs = dataclasses.replace(
            ts.gaussians,
            active_sh_degree=min(iteration // 1000, max_sh_degree))
        total, terms, grads, screen_grads, pkg = loss_and_grads(
            gs, camera, gt_image, iteration, bg, opt_cfg,
            max_sh_degree=max_sh_degree, depth_ratio=depth_ratio,
            cull=cull, device=device)
        xyz_lr = lr_for(iteration if lr_iteration is None
                        else int(lr_iteration))
        lrs = make_lrs(xyz_lr, feature_lr=opt_cfg.feature_lr,
                       opacity_lr=opt_cfg.opacity_lr,
                       scaling_lr=opt_cfg.scaling_lr,
                       rotation_lr=opt_cfg.rotation_lr)
        new_ts = apply_update(gs, ts.opt, grads, screen_grads, pkg["radii"],
                              camera, lrs)
        metrics = {"total_loss": total, **terms,
                   "num_points": gs.params.xyz.shape[0],
                   "num_pairs": pkg["num_pairs"], "xyz_lr": xyz_lr}
        return new_ts, metrics

    return train_step
