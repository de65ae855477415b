"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports neither JAX nor gs2d_tpu, so it runs on a machine with
only PyTorch and CUDA (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from gs2d_torch.config import OptimizationParams
from gs2d_torch.models.gaussians import GaussianParams, GaussianState
from gs2d_torch.ops.rasterize import kernel_bwd, kernel_fwd
from gs2d_torch.ops.rasterize.api import pack_entries, rasterize
from gs2d_torch.ops.rasterize.binning import bin_gaussians
from gs2d_torch.ops.rasterize.preprocess import preprocess
from gs2d_torch.render.renderer import prepare, render
from gs2d_torch.scene.cameras import make_camera
from gs2d_torch.train.optim import FIELDS, init_adam
from gs2d_torch.train.step import TrainState, loss_and_grads, make_train_step

pytestmark = pytest.mark.cuda
TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(device, n=800, seed=0, W=160, H=96):
    rng = np.random.default_rng(seed)
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cam = make_camera(np.eye(3), np.array([0, 0, 4.0]), fovx, fovy, W, H,
                      device=device)
    arr = [rng.uniform(-1, 1, (n, 3)), rng.uniform(0.02, 0.25, (n, 2)),
           rng.normal(size=(n, 4)), rng.uniform(0.2, 0.95, n),
           rng.random((n, 3))]
    return cam, [torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in arr]


def test_kernel_matches_plain_version(cuda):
    cam, (m, s, q, o, c) = _scene(cuda)
    pre = preprocess(m, s, q, o, cam.world_view, cam.full_proj, cam.campos,
                     cam.width, cam.height, colors=c)
    b = bin_gaussians(pre.center2d, pre.extent, pre.depth, pre.visible,
                      cam.width, cam.height)
    args = (pack_entries(pre), b.gid, b.tile_start, b.tile_count,
            cam.width, cam.height)
    before = kernel_fwd.rasterize_fwd.launches
    out, med, nc = kernel_fwd.rasterize_fwd(*args)
    torch.cuda.synchronize()
    assert kernel_fwd.rasterize_fwd.launches == before + 1
    rout, rmed, rnc = kernel_fwd.rasterize_fwd_reference(*args)
    torch.testing.assert_close(out, rout, rtol=TOL, atol=TOL)
    assert (med == rmed).float().mean() >= 0.999
    assert (nc == rnc).float().mean() >= 0.999


def test_render_cuda_matches_cpu(cuda):
    outs = []
    for dev in (cuda, torch.device("cpu")):
        cam, (m, s, q, o, c) = _scene(dev, n=300)
        n = m.shape[0]
        state = GaussianState(GaussianParams(
            xyz=m, features_dc=((c - 0.5) / 0.28209479177387814)[:, None],
            features_rest=torch.zeros((n, 15, 3), device=dev),
            scaling=torch.log(s), rotation=q,
            opacity=torch.logit(o)[:, None]), active_sh_degree=3)
        outs.append(render(cam, state, torch.ones(3, device=dev),
                           device=dev))
    for k in ("render", "rend_alpha", "rend_normal", "depth_expected"):
        torch.testing.assert_close(outs[0][k].cpu(), outs[1][k], rtol=TOL,
                                   atol=TOL)
    assert outs[0]["num_pairs"] == outs[1]["num_pairs"]


def _grad_bar(got, ref, what):
    """tests/test_rasterize_bwd.py:50-57: rtol 1e-3 / atol 5e-4 on values
    normalised by the reference's largest magnitude."""
    scale = ref.abs().max().clamp(min=1e-6)
    torch.testing.assert_close(got / scale, ref / scale, rtol=1e-3,
                               atol=5e-4, msg=what)


def test_bwd_kernel_matches_plain_version(cuda):
    cam, (m, s, q, o, c) = _scene(cuda)
    pre = preprocess(m, s, q, o, cam.world_view, cam.full_proj, cam.campos,
                     cam.width, cam.height, colors=c)
    b = bin_gaussians(pre.center2d, pre.extent, pre.depth, pre.visible,
                      cam.width, cam.height)
    fargs = (pack_entries(pre), b.gid, b.tile_start, b.tile_count)
    out, med, nc = kernel_fwd.rasterize_fwd(*fargs, cam.width, cam.height)
    cot = torch.as_tensor(np.random.default_rng(1).normal(
        size=tuple(out.shape)).astype(np.float32), device=cuda)
    args = fargs + (out, cot, med, nc, cam.width, cam.height)
    before = kernel_bwd.rasterize_bwd.launches
    d = kernel_bwd.rasterize_bwd(*args)
    torch.cuda.synchronize()
    assert kernel_bwd.rasterize_bwd.launches == before + 1
    ref = kernel_bwd.rasterize_bwd_reference(*args)
    assert torch.isfinite(d).all()
    for sl in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12),
               slice(12, 13), slice(13, 16), slice(16, 19), slice(19, 22)):
        _grad_bar(d[:, sl], ref[:, sl], f"columns {sl}")
    # bit for bit on a second launch
    assert torch.equal(kernel_bwd.rasterize_bwd(*args), d)


def _state(dev, n=300):
    cam, (m, s, q, o, c) = _scene(dev, n=n)
    state = GaussianState(GaussianParams(
        xyz=m, features_dc=((c - 0.5) / 0.28209479177387814)[:, None],
        features_rest=torch.zeros((n, 15, 3), device=dev),
        scaling=torch.log(s), rotation=q,
        opacity=torch.logit(o)[:, None]), active_sh_degree=3)
    return cam, state


def _render_grads(dev):
    cam, state = _state(dev)
    p = state.params
    leaves = [p.xyz, p.scaling, p.rotation, p.opacity, p.features_dc]
    for x in leaves:
        x.requires_grad_()
    offsets = torch.zeros((p.xyz.shape[0], 2), device=dev,
                          requires_grad=True)
    res = render(cam, state, torch.ones(3, device=dev),
                 screen_offsets=offsets, device=dev)
    loss = res["render"].sum() + res["rend_dist"].sum() \
        + res["surf_depth"].sum()
    return torch.autograd.grad(loss, leaves + [offsets])


def test_render_gradients_cuda_match_cpu(cuda):
    got = _render_grads(cuda)
    ref = _render_grads(torch.device("cpu"))
    names = ("xyz", "scaling", "rotation", "opacity", "features_dc",
             "screen_offsets")
    for name, a, b in zip(names, got, ref):
        _grad_bar(a.cpu(), b, name)
    # two backward passes give the same gradients bit for bit
    again = _render_grads(cuda)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _step_on(dev):
    cam, state = _state(dev)
    gt = torch.as_tensor(np.random.default_rng(1).random(
        (3, cam.height, cam.width), np.float32), device=dev)
    cfg = OptimizationParams(lambda_dist=10.0)
    bg = torch.zeros(3, device=dev)
    step = make_train_step(cfg, depth_ratio=1.0, device=dev)
    ts, metrics = step(TrainState(gaussians=state,
                                  opt=init_adam(state.params)),
                       cam, gt, 8000, bg)
    grads = loss_and_grads(state, cam, gt, 8000, bg, cfg, depth_ratio=1.0,
                           device=dev)
    with torch.no_grad():
        out, _ = rasterize(prepare(cam, state), cam.width, cam.height)
    return ts, metrics, grads, cfg.lambda_dist * float(
        torch.mean(out[4] * out[14]))


def test_train_step_cuda_matches_cpu(cuda):
    """One step at iteration 8000 (every loss term live, median depth) on
    the card against the same step on the CPU, at the bars of
    tests/test_torch_train_step.py."""
    ts_c, m_c, g_c, _ = _step_on(cuda)
    ts_h, m_h, g_h, dist_scale = _step_on(torch.device("cpu"))
    for k in ("total_loss", "l1", "ssim", "loss", "dist_loss",
              "normal_loss"):
        a, b = float(m_c[k]), float(m_h[k])
        # the distortion term is held at its operands' scale (see there)
        scale = max(abs(b), dist_scale) if k == "dist_loss" else abs(b)
        assert abs(a - b) <= 1e-5 * scale, (k, a, b)
    assert m_c["num_pairs"] == m_h["num_pairs"]
    for f in FIELDS:
        ga, gb = getattr(g_c[2], f).cpu(), getattr(g_h[2], f)
        _grad_bar(ga, gb, f"d {f}")
        a = getattr(ts_c.gaussians.params, f).cpu()
        b = getattr(ts_h.gaussians.params, f)
        assert torch.isfinite(a).all()
        strong = gb.abs() > 1e-3 * gb.abs().max()
        torch.testing.assert_close(a[strong], b[strong], rtol=1e-6,
                                   atol=1e-6, msg=f)
        # a first Adam step moves each value by its group's lr at most
        lr = 0.05 if f == "opacity" else 0.005
        assert (a - b).abs().max() <= 2 * lr, f
    _grad_bar(g_c[3].cpu(), g_h[3], "d screen offsets")
    _grad_bar(ts_c.gaussians.grad_accum.cpu(), ts_h.gaussians.grad_accum,
              "grad_accum")
    assert torch.equal(ts_c.gaussians.denom.cpu(), ts_h.gaussians.denom)
    assert torch.equal(ts_c.gaussians.max_radii2d.cpu(),
                       ts_h.gaussians.max_radii2d)
