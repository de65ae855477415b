"""The training loop.

Counterpart of ``gs2d_tpu/train/loop.py:34-288`` (reference
``train.py:31-168``): random camera order, the step, the densify / prune
cadence (every ``densification_interval`` iterations inside
(``densify_from_iter``, ``densify_until_iter``)), the opacity reset every
``opacity_reset_interval`` (and at ``densify_from_iter`` on a white
background), PLY saves, checkpoints and resume, EMA progress logging.

Tensors resize under densification, so the JAX loop's capacity growth
and pairs-capacity escalation and re-tightening have no counterpart; the
multi-host path is not ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, List, Optional

import torch

from ..config import (ModelParams, OptimizationParams, PipelineParams,
                      RuntimeParams)
from ..models.densify import densify_and_prune, reset_opacity
from ..models.io import load_checkpoint, save_checkpoint
from ..scene.scene import Scene
from ..train.optim import init_adam
from ..train.step import TrainState, make_train_step


def train(model: ModelParams, opt: OptimizationParams, pipe: PipelineParams,
          rt: RuntimeParams, *, scene=None,
          test_iterations: List[int] = (7000, 30000),
          save_iterations: List[int] = (7000, 30000),
          checkpoint_iterations: List[int] = (),
          start_checkpoint: Optional[str] = None,
          log_fn: Optional[Callable] = None,
          report_fn: Optional[Callable] = None,
          profile_dir: Optional[str] = None,
          viewer_fn: Optional[Callable] = None,
          device="cuda"):
    """Train on ``device`` (default ``"cuda"``) → (TrainState, scene).

    With ``scene=None`` the loop builds ``Scene(model, seed=rt.seed,
    device=device)`` from the dataset at ``model.source_path``, as the JAX
    loop does. A caller may pass a scene instead: any object with
    ``gaussians`` (a GaussianState on ``device``), ``cameras_extent``,
    ``model_path``, ``get_train_cameras()`` (a list of ``CameraData``) and
    ``save(iteration, state)``.

    ``log_fn(iteration, record)`` gets the EMA losses every 10 iterations;
    ``report_fn(iteration, ts, scene)`` runs at ``test_iterations``;
    ``profile_dir`` receives a ``torch.profiler`` trace of iterations
    50–60; ``viewer_fn(iteration, ts, ema)`` runs after every iteration.
    """
    device = torch.device(device)
    if scene is None:
        scene = Scene(model, seed=rt.seed, device=device)
    if start_checkpoint:
        gaussians, opt_state, first_iter, _ = load_checkpoint(
            start_checkpoint, device=device)
    else:
        gaussians, first_iter = scene.gaussians, 0
        opt_state = init_adam(gaussians.params)

    spatial_lr_scale = scene.cameras_extent
    bg = torch.tensor([1.0, 1.0, 1.0] if model.white_background
                      else [0.0, 0.0, 0.0], dtype=torch.float32,
                      device=device)
    cams = scene.get_train_cameras()
    if not cams:
        raise ValueError("no training cameras")
    step = make_train_step(opt, max_sh_degree=model.sh_degree,
                           spatial_lr_scale=spatial_lr_scale,
                           depth_ratio=pipe.depth_ratio, device=device)
    ts = TrainState(gaussians=gaussians, opt=opt_state)
    # split noise; the JAX loop's key is likewise seeded afresh on resume
    gen = torch.Generator(device=device).manual_seed(rt.seed)

    ema = {"loss": 0.0, "dist": 0.0, "normal": 0.0}
    stack: List[int] = []
    rng = random.Random(rt.seed)
    gt_cache = {}
    gt_cache_bytes = 0
    prof = None
    t_start = time.time()

    for iteration in range(first_iter + 1, opt.iterations + 1):
        if profile_dir and iteration == 50:
            prof = _start_profiler(device)
        if prof is not None and iteration == 60:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "trace.json"))
            prof = None
        if not stack:
            stack = list(range(len(cams)))
        cam_idx = stack.pop(rng.randrange(len(stack)))
        cam_data = cams[cam_idx]
        # ground truth stays on the device across epochs, up to the budget
        gt = gt_cache.get(cam_idx)
        if gt is None:
            gt = torch.as_tensor(cam_data.image, dtype=torch.float32,
                                 device=device)
            nbytes = gt.numel() * gt.element_size()
            if gt_cache_bytes + nbytes <= rt.gt_cache_budget:
                gt_cache[cam_idx] = gt
                gt_cache_bytes += nbytes

        ts, metrics = step(ts, cam_data.camera, gt, iteration, bg)

        # densification schedule (reference train.py:126-135)
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0):
                size_threshold = 20.0 \
                    if iteration > opt.opacity_reset_interval else 0.0
                gs_new, opt_new, _ = densify_and_prune(
                    ts.gaussians, ts.opt, opt.densify_grad_threshold,
                    opt.opacity_cull, scene.cameras_extent, size_threshold,
                    opt.percent_dense, generator=gen)
                ts = TrainState(gaussians=gs_new, opt=opt_new)
            if (iteration % opt.opacity_reset_interval == 0
                    or (model.white_background
                        and iteration == opt.densify_from_iter)):
                gs_new, opt_new = reset_opacity(ts.gaussians, ts.opt)
                ts = TrainState(gaussians=gs_new, opt=opt_new)

        # one host read of the loss terms every 10 iterations
        if iteration % 10 == 0:
            loss, dist, normal = torch.stack(
                [metrics["loss"], metrics["dist_loss"],
                 metrics["normal_loss"]]).tolist()
            ema["loss"] = 0.4 * loss + 0.6 * ema["loss"]
            ema["dist"] = 0.4 * dist + 0.6 * ema["dist"]
            ema["normal"] = 0.4 * normal + 0.6 * ema["normal"]
            if log_fn:
                rec = {"loss": ema["loss"], "dist": ema["dist"],
                       "normal": ema["normal"],
                       "points": int(metrics["num_points"]),
                       "elapsed_s": time.time() - t_start}
                if iteration % 500 == 0 and device.type == "cuda":
                    rec["peak_gib"] = \
                        torch.cuda.max_memory_allocated(device) / 2**30
                log_fn(iteration, rec)
        if report_fn and iteration in test_iterations:
            report_fn(iteration, ts, scene)
        if iteration in save_iterations and scene.model_path:
            scene.save(iteration, ts.gaussians)
        if iteration in checkpoint_iterations and scene.model_path:
            save_checkpoint(
                os.path.join(scene.model_path, f"chkpnt{iteration}.npz"),
                ts.gaussians, ts.opt, iteration, spatial_lr_scale)
        if viewer_fn is not None:
            viewer_fn(iteration, ts, ema)

    if prof is not None:
        prof.stop()
    return ts, scene


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof
