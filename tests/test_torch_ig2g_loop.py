"""The training loop's IG2G editor hook (``loop.train(editor=...)``)
against the loop that ``cli/train_ig2g.py::main`` ran inline before the
hook existed, kept here as ``_inline_ig2g_loop``, on the CPU with the
stub editor.

A tiny COLMAP scene of the torus (48x40, 8 views, a 300-point seed
cloud), 40 iterations with densification in (5, 30) and an opacity reset
at 20, edits every 2 iterations after iteration 10 until each camera's
share is done. Equal, exactly: the camera of every step, the edit
iterations and their cameras, every step's total loss, the edited images
and the final state. The hook leaves the loop as it was without an
editor: no edit is made and the step gets no separate xyz clock.
"""

import random

import pytest
import torch

from gs2d_torch.config import (ModelParams, OptimizationParams,
                               PipelineParams, RuntimeParams)
from gs2d_torch.ig2g.ip2p import InstructPix2Pix, IP2PParams
from gs2d_torch.ig2g.ops import resize_bilinear
from gs2d_torch.models.densify import densify_and_prune, reset_opacity
from gs2d_torch.render.renderer import render
from gs2d_torch.scene.scene import Scene
from gs2d_torch.train import loop
from gs2d_torch.train.optim import FIELDS, init_adam
from gs2d_torch.train.step import TrainState, make_train_step
from gs2d_torch.utils import synthetic_scene as ss

from .test_torch_common import one_torch_thread  # noqa: F401

ITERS, START, CYCLE, PER_CAM = 40, 10, 16, 1
OPT = dict(iterations=ITERS, densify_from_iter=5, densify_until_iter=30,
           densification_interval=10, opacity_reset_interval=20,
           densify_grad_threshold=1e-5)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ig2g_loop") / "scene"
    surf = ss.torus_surfels(4000)
    ss.write_colmap_scene(str(root), ss.SurfelRenderer(surf, device="cpu"),
                          48, 40, 8,
                          seed_points=ss.seed_cloud(surf[0], surf[4], 300))
    return root


def _model(scene_dir):
    return ModelParams(sh_degree=1, source_path=str(scene_dir),
                       model_path="")


def _editor():
    return InstructPix2Pix(IP2PParams(diffusion_steps=4), backend="stub",
                           seed=0, device="cpu")


def _inline_ig2g_loop(scene, model, opt, pipe, rt, ip2p):
    """The loop of ``cli/train_ig2g.py::main`` before the hook, less its
    printing and saving: → (order, edits as (iteration, camera, image),
    losses, final state)."""
    device = torch.device("cpu")
    cams = scene.get_train_cameras()
    edited = [None] * len(cams)
    bg = torch.zeros(3, dtype=torch.float32, device=device)
    step_fn = make_train_step(opt, max_sh_degree=model.sh_degree,
                              spatial_lr_scale=scene.cameras_extent,
                              depth_ratio=pipe.depth_ratio, device=device)
    ts = TrainState(gaussians=scene.gaussians,
                    opt=init_adam(scene.gaussians.params))
    densify_gen = torch.Generator(device=device).manual_seed(rt.seed)
    noise_gen = torch.Generator(device=device).manual_seed(rt.seed + 1)
    rng = random.Random(rt.seed)
    stack, order, edits, losses = [], [], [], []
    ip2p_iteration = 0
    edit_every = max(int(CYCLE / max(len(cams), 1)), 1)
    for iteration in range(1, opt.iterations + 1):
        if not stack:
            stack = list(range(len(cams)))
        ci = stack.pop(rng.randrange(len(stack)))
        cam_data = cams[ci]
        order.append(ci)
        if edited[ci] is None:
            edited[ci] = torch.as_tensor(cam_data.image, dtype=torch.float32,
                                         device=device)
        if (iteration > START
                and (edit_every == 1 or iteration % edit_every == 1)
                and ip2p_iteration < PER_CAM * len(cams)):
            with torch.no_grad():
                gnoise = torch.randn(
                    (ts.gaussians.params.xyz.shape[0], 3),
                    generator=noise_gen, device=device)
                pkg = render(cam_data.camera, ts.gaussians, bg,
                             max_sh_degree=model.sh_degree, noise=gnoise,
                             depth_ratio=pipe.depth_ratio, device=device)
                rendered = torch.clamp(pkg["render"], 0, 1)[None]
                original = torch.as_tensor(
                    cam_data.image, dtype=torch.float32, device=device)[None]
                out = ip2p.edit_image(None, rendered, original,
                                      pkg["rend_noise"][None])
                if out.shape[2:] != rendered.shape[2:]:
                    out = resize_bilinear(out, rendered.shape[2:])
            edited[ci] = out[0]
            ip2p_iteration += 1
            edits.append((iteration, ci, out))
        lr_it = iteration - START if iteration > START else iteration
        ts, metrics = step_fn(ts, cam_data.camera, edited[ci], iteration,
                              bg, lr_iteration=lr_it)
        losses.append(float(metrics["total_loss"]))
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0):
                size_thr = 20.0 if iteration > opt.opacity_reset_interval \
                    else 0.0
                gs_new, opt_new, _ = densify_and_prune(
                    ts.gaussians, ts.opt, opt.densify_grad_threshold,
                    opt.opacity_cull, scene.cameras_extent, size_thr,
                    opt.percent_dense, generator=densify_gen)
                ts = TrainState(gaussians=gs_new, opt=opt_new)
            if iteration % opt.opacity_reset_interval == 0:
                gs_new, opt_new = reset_opacity(ts.gaussians, ts.opt)
                ts = TrainState(gaussians=gs_new, opt=opt_new)
    return order, edits, losses, ts


def _hooked(scene_dir, editor, opt, budget=4 << 30):
    """``loop.train`` with the hook (or none) → (order, edits, losses,
    state, the xyz clocks the step was given)."""
    model = _model(scene_dir)
    rt = RuntimeParams(seed=0, gt_cache_budget=budget)
    scene = Scene(model, seed=rt.seed, device="cpu")
    order, losses, edits, clocks = [], [], [], []
    make = loop.make_train_step

    def make_recorded(*a, **kw):
        step = make(*a, **kw)

        def recorded(ts, camera, gt, iteration, bg, **k):
            clocks.append(k.get("lr_iteration"))
            return step(ts, camera, gt, iteration, bg, **k)
        return recorded

    hook = None
    if editor is not None:
        hook = loop.Editor(
            edit=lambda r, o, n: editor.edit_image(None, r, o, n),
            start_iter=START, cycle_iter=CYCLE, iters=PER_CAM,
            on_edit=lambda it, ci, out, s: edits.append((it, ci, out)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "make_train_step", make_recorded)
        ts, _ = loop.train(
            model, opt, PipelineParams(), rt, scene=scene,
            test_iterations=(), save_iterations=(),
            step_fn=lambda it, ci, m: (order.append(ci), losses.append(
                float(m["total_loss"]))),
            editor=hook, device="cpu")
    return order, edits, losses, ts, clocks


@pytest.mark.parametrize("budget", [4 << 30, 48 * 40 * 4 * 3 * 3])
def test_the_hook_runs_the_inline_loop(scene_dir, budget):
    """With the cache holding every view, and only three (so originals
    are uploaded again and an edit's original is not cached)."""
    opt = OptimizationParams(**OPT)
    model = _model(scene_dir)
    want = _inline_ig2g_loop(Scene(model, seed=0, device="cpu"), model, opt,
                             PipelineParams(), RuntimeParams(seed=0),
                             _editor())
    got = _hooked(scene_dir, _editor(), opt, budget)
    assert got[0] == want[0]
    assert [e[:2] for e in got[1]] == [e[:2] for e in want[1]]
    assert [e[0] for e in want[1]] == list(range(11, 27, 2))
    assert len({e[1] for e in want[1]}) < len(want[1]), \
        "no camera is edited twice"
    for (_, _, a), (_, _, b) in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert got[2] == want[2]
    assert got[4] == [i - START if i > START else i
                      for i in range(1, ITERS + 1)]
    for f in FIELDS:
        assert torch.equal(getattr(got[3].gaussians.params, f),
                           getattr(want[3].gaussians.params, f)), f


def test_without_an_editor_nothing_is_edited(scene_dir):
    opt = OptimizationParams(**OPT)
    order, edits, losses, _, clocks = _hooked(scene_dir, None, opt)
    assert edits == [] and len(order) == len(losses) == ITERS
    assert clocks == [None] * ITERS


def test_the_editor_runs_in_one_process_only(scene_dir):
    with pytest.raises(ValueError, match="one process"):
        loop.train(_model(scene_dir), OptimizationParams(**OPT),
                   PipelineParams(), RuntimeParams(), scene=object(),
                   editor=loop.Editor(edit=None), group=object(),
                   device="cpu")
