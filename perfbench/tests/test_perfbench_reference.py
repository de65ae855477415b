"""The plain reference agrees with the port's CPU render and training
step at a tiny size, and its composited-pair count, from the geometry
alone, is the port's own count with the interval cull on and off."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import scene as scenes
from perfbench.drivers.train import OPT, _moments
from perfbench.reference import raster
from perfbench.reference import train as ref

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _scene(name, n=1500, scale=0.05, seed=2147483917):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    rig = scenes.make_rig(cfg, scale)
    return scenes.make_params(cfg, seed, "cpu", n), rig


def _program(params, view):
    from gs2d_torch.models.gaussians import GaussianParams, GaussianState
    from gs2d_torch.scene.cameras import make_camera
    cam = make_camera(view.R, view.t, view.fovx, view.fovy, view.width,
                      view.height, device="cpu")
    return GaussianState(GaussianParams(**params), active_sh_degree=3), cam


@pytest.mark.parametrize("name", ["m360-outdoor", "m360-indoor"])
def test_render_matches_the_port(name):
    from gs2d_torch.render.renderer import render
    params, rig = _scene(name)
    bg = torch.zeros(3)
    for k in rig.test[:3]:
        view = rig.views[k]
        state, cam = _program(params, view)
        with torch.no_grad():
            got = render(cam, state, bg, device="cpu")
        want = raster.render(params, view, bg)
        # by Σ|got − want| / Σ|want|, as the benchmark compares them: a
        # pixel whose transmittance or alpha sits at a threshold to
        # rounding may flip; the depth map's normals difference
        # neighbouring depths, which amplifies their rounding at steps
        for key, tol in (("render", 1e-5), ("rend_alpha", 1e-5),
                         ("rend_normal", 1e-5), ("surf_depth", 1e-5),
                         ("surf_normal", 1e-4)):
            d = (got[key] - want[key]).abs().sum()
            assert d <= tol * want[key].abs().sum(), key
        scale = want["dist_scale"].sum()
        assert (got["rend_dist"] - want["rend_dist"]).abs().sum() \
            < 1e-5 * scale


def test_training_step_matches_the_port():
    from gs2d_torch.config import OptimizationParams
    from gs2d_torch.models.gaussians import GaussianParams
    from gs2d_torch.train.optim import AdamState
    from gs2d_torch.train.step import TrainState, make_train_step
    params, rig = _scene("m360-outdoor")
    view = rig.views[rig.train[5]]
    state, cam = _program({f: x.clone() for f, x in params.items()}, view)
    gt = torch.rand(3, view.height, view.width,
                    generator=torch.Generator().manual_seed(3))
    extent = scenes.camera_extent([rig.views[i] for i in rig.train])
    step = make_train_step(OptimizationParams(), spatial_lr_scale=extent,
                           device="cpu")
    mu, nu = _moments(params, 7, "cpu")
    opt = AdamState(GaussianParams(**{f: mu[f].clone() for f in mu}),
                    GaussianParams(**{f: nu[f].clone() for f in nu}), 15000)
    ts, metrics = step(TrainState(state, opt), cam, gt, 15001, torch.zeros(3))
    loss, grads = ref.gradient(params, view, gt, 15001, OPT, torch.zeros(3))
    assert abs(float(metrics["total_loss"]) - float(loss)) < 1e-5 * float(loss)
    p1, _, _ = ref.adam(params, grads, mu, nu, 15001,
                        ref.learning_rates(15001, extent, OPT))
    for f in ref.FIELDS:
        g_prog = (getattr(ts.opt.mu, f) - ref.BETA1 * mu[f]) \
            / (1 - ref.BETA1)
        scale = grads[f].abs().max()
        assert torch.allclose(g_prog, grads[f], rtol=1e-3,
                              atol=1e-4 * float(scale)), f
        assert torch.allclose(getattr(ts.gaussians.params, f), p1[f],
                              rtol=1e-5, atol=1e-6), f


@pytest.mark.parametrize("name", ["m360-outdoor", "m360-indoor"])
def test_counts_follow_the_geometry_not_the_slots(name):
    """Turning the port's interval cull on or off changes its slots but
    not the yardstick's count, which equals the pairs the port's plain
    K1 composites either way."""
    from gs2d_torch.ops.rasterize.api import bin_preprocessed, pack_entries
    from gs2d_torch.ops.rasterize.kernel_fwd import rasterize_fwd_reference
    from gs2d_torch.render.renderer import prepare
    params, rig = _scene(name)
    view = rig.views[rig.test[1]]
    state, cam = _program(params, view)
    W, H = view.width, view.height
    pairs, visible, pixels = raster.composited_pairs(params, view, stride=1)
    slots, composited = {}, {}
    for cull in (True, False):
        with torch.no_grad():
            pre = prepare(cam, state)
            bins = bin_preprocessed(pre, W, H, cull=cull)
            out = rasterize_fwd_reference(pack_entries(pre), bins.gid,
                                          bins.tile_start, bins.tile_count,
                                          W, H, return_composited=True)
        slots[cull], composited[cull] = bins.num_pairs, out[3]
    assert slots[True] < slots[False]
    assert composited[True] == composited[False] == pairs
    assert pixels == W * H and 0 < visible <= params["xyz"].shape[0]
    lattice, _, _ = raster.composited_pairs(params, view, stride=4)
    assert abs(lattice - pairs) < 0.25 * pairs
