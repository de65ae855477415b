"""The training loop.

Counterpart of ``gs2d_tpu/train/loop.py:34-288`` (reference
``train.py:31-168``): random camera order, the step, the densify / prune
cadence (every ``densification_interval`` iterations inside
(``densify_from_iter``, ``densify_until_iter``)), the opacity reset every
``opacity_reset_interval`` (and at ``densify_from_iter`` on a white
background), PLY saves, checkpoints and resume, EMA progress logging.

Tensors resize under densification, so the JAX loop's capacity growth
and pairs-capacity escalation and re-tightening have no counterpart.

With a process ``group`` (``gs2d_tpu/train/loop.py:40-54``, ``:125-131``;
``parallel/multihost.py``) every rank runs the same data-parallel steps
and densify draws on the same seeded camera order, starting from the
first rank's state; every densify checks that the ranks still hold the
same state; only the first rank has side effects (PLYs, checkpoints, the
callbacks). With ``multihost`` each rank uploads only its row band of a
view and the bands are assembled on every rank.

With an ``editor`` (``Editor``) the loop is the IG2G fork's
(``train_ig2g.py:190-304``; InstructNeRF2NeRF's Iterative Dataset
Update): after ``start_iter``, every ``int(cycle_iter / n_cameras)``
iterations until ``iters · n_cameras`` edits are done, the iteration's
camera is rendered with per-surfel Gaussian noise (a generator seeded
``rt.seed + 1``) composited into the ``rend_noise`` channels, the
editor's ``edit`` turns the render, the camera's original image and the
noise render into an edited image, which is resized back to the render's
size where the VAE's ×8 round trip changed it and becomes that camera's
ground truth, resident on the device whatever ``gt_cache_budget`` says
(the original leaves the cache). The xyz learning rate restarts at
``start_iter``. Spans: ``ig2g.edit`` around an edit, with
``ig2g.edit_render`` and ``ig2g.resize`` inside it.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable, List, Optional

import torch

from ..config import (ModelParams, OptimizationParams, PipelineParams,
                      RuntimeParams)
from ..ig2g import ops as ig2g_ops
from ..models.densify import densify_and_prune, reset_opacity
from ..models.io import load_checkpoint, save_checkpoint
from ..parallel.data_parallel import broadcast_from_main, check_replicas
from ..parallel.multihost import (global_gt_from_local_rows, is_main_process,
                                  local_row_range)
from ..render.renderer import render
from ..scene.scene import Scene
from ..train.optim import FIELDS, init_adam
from ..utils import trace
from . import step as step_module
from .step import TrainState


def make_train_step(*args, **kwargs):
    """``step.make_train_step``, looked up at each call: a step installed
    there reaches the loop (the IG2G CLI's tests record the steps of
    ``cli/train_ig2g.py`` so), as does one installed here."""
    return step_module.make_train_step(*args, **kwargs)


@dataclasses.dataclass
class Editor:
    """The IG2G dataset update as a hook of ``train``.

    ``edit(rendered, original, rend_noise)`` gets (1, 3, H, W) tensors on
    the device (the clamped noisy render, the camera's original image,
    the render's ``rend_noise`` channels) and returns the edited image,
    (1, 3, h, w); ``on_edit(iteration, cam_idx, image, seconds)``, if
    given, sees each edit as the camera's new ground truth, with the
    seconds it took (the device synchronised)."""
    edit: Callable
    start_iter: int = 20000
    cycle_iter: int = 2500
    iters: int = 3
    on_edit: Optional[Callable] = None

    def every(self, n_cams: int) -> int:
        return max(int(self.cycle_iter / max(n_cams, 1)), 1)

    def due(self, iteration: int, done: int, n_cams: int) -> bool:
        every = self.every(n_cams)
        return (iteration > self.start_iter
                and (every == 1 or iteration % every == 1)
                and done < self.iters * n_cams)

    def lr_iteration(self, iteration: int) -> int:
        """The xyz learning rate's clock, restarted at ``start_iter``."""
        return (iteration - self.start_iter if iteration > self.start_iter
                else iteration)


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
          step_fn: Optional[Callable] = None,
          editor: Optional[Editor] = None,
          device="cuda", group=None, multihost: bool = False):
    """Train on ``device`` (default ``"cuda"``) → (TrainState, scene).

    With ``scene=None`` the loop builds ``Scene(model, seed=rt.seed,
    device=device)`` from the dataset at ``model.source_path``, as the JAX
    loop does. A caller may pass a scene instead: any object with
    ``gaussians`` (a GaussianState on ``device``), ``cameras_extent``,
    ``model_path``, ``get_train_cameras()`` (a list of ``CameraData``) and
    ``save(iteration, state)``.

    ``log_fn(iteration, record)`` gets the EMA losses every 10 iterations
    and, every 500 on the card, ``peak_hbm_gb``;
    ``report_fn(iteration, ts, scene)`` runs at ``test_iterations``;
    ``profile_dir`` receives a ``torch.profiler`` trace of iterations
    50–60 (``trace.json``) and the spans and counters of
    ``utils/trace.py`` recorded over them (``spans.json``);
    ``viewer_fn(iteration, ts, ema)`` runs after every iteration;
    ``step_fn(iteration, cam_idx, metrics)`` after every step.
    With a ``group`` they run on its first rank only, as do the saves.
    ``editor`` (one process only) edits the ground truth as the module's
    docstring says.
    """
    device = torch.device(device)
    if multihost and group is None:
        raise ValueError("multihost training needs a process group")
    if editor is not None and group is not None:
        raise ValueError("the IG2G editor runs in one process only")
    io_ok = group is None or is_main_process()
    if scene is None:
        # only the first rank writes the scene's files (input.ply,
        # cameras.json)
        scene = Scene(model if io_ok else dataclasses.replace(
            model, model_path=""), seed=rt.seed, device=device)
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
                           depth_ratio=pipe.depth_ratio, device=device,
                           group=group)
    ts = TrainState(gaussians=gaussians, opt=opt_state)
    if group is not None:
        broadcast_from_main(_replicated(ts), group)
    # split noise; the JAX loop's key is likewise seeded afresh on resume
    gen = torch.Generator(device=device).manual_seed(rt.seed)

    ema = {"loss": 0.0, "dist": 0.0, "normal": 0.0}
    stack: List[int] = []
    rng = random.Random(rt.seed)
    gt_cache = {}
    gt_cache_bytes = 0
    edited = {}            # camera → its edited ground truth
    n_edits = 0
    if editor is not None:
        noise_gen = torch.Generator(device=device).manual_seed(rt.seed + 1)
    prof = None
    t_start = time.time()

    for iteration in range(first_iter + 1, opt.iterations + 1):
        if profile_dir and io_ok and iteration == 50:
            prof = trace.profiler(device)
        if prof is not None and iteration == 60:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "trace.json"))
            trace.write(os.path.join(profile_dir, "spans.json"))
            prof = None
        if not stack:
            stack = list(range(len(cams)))
        cam_idx = stack.pop(rng.randrange(len(stack)))
        cam_data = cams[cam_idx]
        # ground truth stays on the device across epochs, up to the budget
        gt = edited.get(cam_idx, gt_cache.get(cam_idx))
        if gt is None:
            with trace.span("loop.gt_upload"):
                trace.count("gt.upload")
                # a copy from pageable host memory waits for the stream
                trace.count("sync")
                if multihost:
                    # rank-local IO: upload only this rank's row band
                    h = cam_data.image.shape[1]
                    r0, r1 = local_row_range(h, group)
                    gt = global_gt_from_local_rows(torch.as_tensor(
                        cam_data.image[:, r0:r1], dtype=torch.float32,
                        device=device), h, group)
                else:
                    gt = torch.as_tensor(cam_data.image, dtype=torch.float32,
                                         device=device)
                nbytes = gt.numel() * gt.element_size()
                if gt_cache_bytes + nbytes <= rt.gt_cache_budget:
                    gt_cache[cam_idx] = gt
                    gt_cache_bytes += nbytes

        step_kw = {}
        if editor is not None:
            if editor.due(iteration, n_edits, len(cams)):
                original = None if cam_idx in edited else gt
                if gt_cache.pop(cam_idx, None) is not None:
                    gt_cache_bytes -= gt.numel() * gt.element_size()
                gt = edited[cam_idx] = _edit(
                    editor, iteration, cam_idx, cam_data, original, ts, bg,
                    noise_gen, model.sh_degree, pipe.depth_ratio, device)
                n_edits += 1
            step_kw["lr_iteration"] = editor.lr_iteration(iteration)
        with trace.span("loop.step"):
            ts, metrics = step(ts, cam_data.camera, gt, iteration, bg,
                               **step_kw)
        if step_fn is not None and io_ok:
            step_fn(iteration, cam_idx, metrics)

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
                if group is not None:
                    check_replicas(_replicated(ts), group,
                                   f"the state after densify {iteration}")
            if (iteration % opt.opacity_reset_interval == 0
                    or (model.white_background
                        and iteration == opt.densify_from_iter)):
                gs_new, opt_new = reset_opacity(ts.gaussians, ts.opt)
                ts = TrainState(gaussians=gs_new, opt=opt_new)

        # one host read of the loss terms every 10 iterations
        if iteration % 10 == 0:
            trace.count("sync")
            loss, dist, normal = torch.stack(
                [metrics["loss"], metrics["dist_loss"],
                 metrics["normal_loss"]]).tolist()
            ema["loss"] = 0.4 * loss + 0.6 * ema["loss"]
            ema["dist"] = 0.4 * dist + 0.6 * ema["dist"]
            ema["normal"] = 0.4 * normal + 0.6 * ema["normal"]
            if log_fn and io_ok:
                rec = {"loss": ema["loss"], "dist": ema["dist"],
                       "normal": ema["normal"],
                       "points": int(metrics["num_points"]),
                       "elapsed_s": time.time() - t_start}
                peak = peak_hbm_gb(device) if iteration % 500 == 0 \
                    else None
                if peak is not None:
                    rec["peak_hbm_gb"] = peak
                log_fn(iteration, rec)
        if not io_ok:
            continue
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


def _edit(editor: Editor, iteration: int, cam_idx: int, cam_data, original,
          ts: TrainState, bg, noise_gen, sh_degree: int, depth_ratio: float,
          device) -> torch.Tensor:
    """One IG2G edit of the camera's view → its new ground truth, (3, H,
    W). ``original`` is the camera's image on the device, or None."""
    t0 = time.perf_counter()
    with trace.span("ig2g.edit"), torch.no_grad():
        if original is None:
            trace.count("sync")
            original = torch.as_tensor(cam_data.image, dtype=torch.float32,
                                       device=device)
        with trace.span("ig2g.edit_render"):
            noise = torch.randn((ts.gaussians.params.xyz.shape[0], 3),
                                generator=noise_gen, device=device)
            pkg = render(cam_data.camera, ts.gaussians, bg,
                         max_sh_degree=sh_degree, noise=noise,
                         depth_ratio=depth_ratio, device=device)
            rendered = torch.clamp(pkg["render"], 0, 1)[None]
        out = editor.edit(rendered, original[None], pkg["rend_noise"][None])
        # the VAE's x8 round trip returns sides rounded up to a multiple
        # of 8: back to the render's size (train_ig2g.py:293-297)
        if out.shape[2:] != rendered.shape[2:]:
            with trace.span("ig2g.resize"):
                out = ig2g_ops.resize_bilinear(out, rendered.shape[2:])
        if device.type == "cuda":
            trace.count("sync")
            torch.cuda.synchronize(device)
    if editor.on_edit is not None:
        editor.on_edit(iteration, cam_idx, out, time.perf_counter() - t0)
    return out[0]


def peak_hbm_gb(device: torch.device) -> Optional[float]:
    """The allocator's peak on the card in GiB (bytes / 2^30), the run
    log's ``peak_hbm_gb`` as the JAX loop writes it
    (``gs2d_tpu/train/loop.py:272``); None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def _replicated(ts: TrainState) -> list:
    """The tensors every rank of a data-parallel run holds alike."""
    g = ts.gaussians
    return ([getattr(g.params, f) for f in FIELDS]
            + [getattr(ts.opt.mu, f) for f in FIELDS]
            + [getattr(ts.opt.nu, f) for f in FIELDS]
            + [g.max_radii2d, g.grad_accum, g.denom])
