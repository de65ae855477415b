"""The plain reference agrees with the port's CPU render and training
step at a tiny size, and its composited-pair count, from the geometry
alone, is the port's own count with the interval cull on and off."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import scene as scenes
from perfbench.drivers.train import OPT, _moments, loss_weights
from perfbench.reference import raster
from perfbench.reference import train as ref

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _scene(name, n=1500, scale=0.05, seed=2147483917):
    cfg = _config(name)
    rig = scenes.make_rig(cfg, scale)
    return scenes.make_params(cfg, seed, "cpu", n), rig


def _program(params, view):
    from gs2d_torch.models.gaussians import GaussianParams, GaussianState
    from gs2d_torch.scene.cameras import make_camera
    cam = make_camera(view.R, view.t, view.fovx, view.fovy, view.width,
                      view.height, device="cpu")
    return GaussianState(GaussianParams(**params), active_sh_degree=3), cam


@pytest.mark.parametrize("name", ["m360-outdoor", "m360-indoor",
                                  "dtu-object"])
def test_render_matches_the_port(name):
    """At the configuration's depth ratio: 1 for the DTU object, whose
    surface depth and depth normals are then the median depth's."""
    from gs2d_torch.render.renderer import render
    params, rig = _scene(name)
    ratio = float(_config(name)["optimization"]["depth_ratio"])
    bg = torch.zeros(3)
    views = (rig.test + rig.train)[:3]
    for k in views:
        view = rig.views[k]
        state, cam = _program(params, view)
        with torch.no_grad():
            got = render(cam, state, bg, depth_ratio=ratio, device="cpu")
        want = raster.render(params, view, bg, depth_ratio=ratio)
        # by Σ|got − want| / Σ|want|, as the benchmark compares them: a
        # pixel whose transmittance or alpha sits at a threshold to
        # rounding may flip; the depth map's normals difference
        # neighbouring depths, which amplifies their rounding at steps
        for key, tol in (("render", 1e-5), ("rend_alpha", 1e-5),
                         ("rend_normal", 1e-5), ("surf_depth", 1e-5),
                         ("surf_normal", 1e-4), ("depth_median", 1e-5)):
            d = (got[key] - want[key]).abs().sum()
            assert d <= tol * want[key].abs().sum(), key
        scale = want["dist_scale"].sum()
        assert (got["rend_dist"] - want["rend_dist"]).abs().sum() \
            < 1e-5 * scale


@pytest.mark.parametrize("name,drop,bar", [
    ("m360-outdoor", (), None), ("dtu-object", ("lambda_dist",), 1e-3),
    ("dtu-object", (), 1e-2)],
    ids=["m360-outdoor", "dtu-object-median", "dtu-object"])
def test_training_step_matches_the_port(name, drop, bar):
    """With the configuration's loss weights and depth ratio: the
    defaults outdoors, every gradient held element by element; for the
    DTU object the normal loss on the median depth's normals, without
    and with the distortion at 1000, each leaf held by the norm of its
    difference over its own (``bar``).

    Without the distortion one surfel met nearly edge-on carries a
    gradient that is rounding noise on both sides (its position's row is
    off by 2.4e-6 of 1.5e-3, as at depth ratio 0), and the leaves are off
    by 1.3e-4 at most; the median depth in place of the expected one
    moves the position and rotation gradients by 0.4 of their norms.
    With the distortion on, the
    port, as 2DGS's rasterizer, takes each surfel's distortion gradient
    S0·m² + M2 − 2m·M1 in float32 from terms near 1 that cancel to about
    1e-4, so its leaves are off by up to 2.2e-3 (the same step with the
    port's compositing carried in float64 is off by 4e-5, and the
    reference in float32 by 1.6e-6, of a float64 reference), and its
    loss by 7e-6 (1e-8 in float64); leaving the distortion out moves
    the leaves by 0.7 to 0.94."""
    from gs2d_torch.config import OptimizationParams
    from gs2d_torch.models.gaussians import GaussianParams
    from gs2d_torch.train.optim import AdamState
    from gs2d_torch.train.step import TrainState, make_train_step
    cfg = _config(name)
    for k in drop:
        del cfg["optimization"][k]
    weights = loss_weights(cfg)
    ratio = float(cfg["optimization"]["depth_ratio"])
    params, rig = _scene(name)
    view = rig.views[rig.train[5]]
    state, cam = _program({f: x.clone() for f, x in params.items()}, view)
    gt = torch.rand(3, view.height, view.width,
                    generator=torch.Generator().manual_seed(3))
    extent = scenes.camera_extent([rig.views[i] for i in rig.train])
    step = make_train_step(OptimizationParams(**weights),
                           spatial_lr_scale=extent, depth_ratio=ratio,
                           device="cpu")
    mu, nu = _moments(params, 7, "cpu")
    opt = AdamState(GaussianParams(**{f: mu[f].clone() for f in mu}),
                    GaussianParams(**{f: nu[f].clone() for f in nu}), 15000)
    ts, metrics = step(TrainState(state, opt), cam, gt, 15001, torch.zeros(3))
    opt_ref = {**OPT, **weights}
    loss, grads = ref.gradient(params, view, gt, 15001, opt_ref,
                               torch.zeros(3), depth_ratio=ratio)
    dist = opt_ref["lambda_dist"] > 0
    assert abs(float(metrics["total_loss"]) - float(loss)) \
        < (5e-5 if dist else 1e-5) * float(loss)
    p1, _, _ = ref.adam(params, grads, mu, nu, 15001,
                        ref.learning_rates(15001, extent, opt_ref))
    for f in ref.FIELDS:
        g_prog = (getattr(ts.opt.mu, f) - ref.BETA1 * mu[f]) \
            / (1 - ref.BETA1)
        if bar is not None:
            gap = torch.linalg.vector_norm((g_prog - grads[f]).double()) \
                / torch.linalg.vector_norm(grads[f].double())
            assert gap < bar, (f, float(gap))
            continue
        scale = grads[f].abs().max()
        assert torch.allclose(g_prog, grads[f], rtol=1e-3,
                              atol=1e-4 * float(scale)), f
        assert torch.allclose(getattr(ts.gaussians.params, f), p1[f],
                              rtol=1e-5, atol=1e-6), f


def test_depth_ratio_0_leaves_the_reference_as_it_was(monkeypatch):
    """At depth ratio 0 the median depth channel reaches nothing: the
    render's outputs, the loss and every gradient are bit for bit those
    of the reference with that channel taken out (one thread, so that
    the gradient's sums keep one order)."""
    params, rig = _scene("m360-outdoor")
    view = rig.views[rig.train[3]]
    gt = torch.rand(3, view.height, view.width,
                    generator=torch.Generator().manual_seed(3))
    bg = torch.zeros(3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = []
        for without in (False, True):
            if without:
                monkeypatch.setattr(raster, "_median",
                                    lambda z, live, t: torch.zeros_like(
                                        z[:, 0]).detach())
            out = raster.render(params, view, bg)
            out.pop("depth_median")
            got.append((out, *ref.gradient(params, view, gt, 15001, OPT, bg)))
    finally:
        torch.set_num_threads(threads)
    (out0, loss0, g0), (out1, loss1, g1) = got
    assert out0.keys() == out1.keys()
    assert all(torch.equal(out0[k], out1[k]) for k in out0)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g0[f], g1[f]) for f in ref.FIELDS)
    assert torch.equal(out0["surf_depth"], raster.render(
        params, view, bg, depth_ratio=0.0)["surf_depth"])


def test_median_depth_is_the_last_surfel_in_front_of_half():
    """Three surfels on one pixel, alpha 0.3 each, at depths 1, 2, 3:
    the transmittance in front of them is 1, 0.7, 0.49, so the median is
    the second's depth, and its gradient reaches that depth alone."""
    z = torch.tensor([1.0, 2.0, 3.0]).reshape(1, 3, 1).requires_grad_()
    live = torch.ones(1, 3, 1, dtype=torch.bool)
    t_before = torch.tensor([1.0, 0.7, 0.49]).reshape(1, 3, 1)
    med = raster._median(z, live, t_before)
    assert med.tolist() == [[2.0]]
    med.sum().backward()
    assert z.grad.flatten().tolist() == [0.0, 1.0, 0.0]
    # a surfel that does not composite is passed over; none → 0
    live[0, 1, 0] = False
    assert raster._median(z, live, t_before).tolist() == [[1.0]]
    assert raster._median(z, torch.zeros_like(live),
                          t_before).tolist() == [[0.0]]


def test_the_configurations_loss_weights():
    """The M360 configurations name none, so both sides keep the
    defaults, which are the program's; the DTU object's distortion
    weight reaches both; any other key stops the run, a weight that no
    published protocol sets among them."""
    from gs2d_torch.config import OptimizationParams
    defaults = OptimizationParams()
    for k in ("lambda_dist", "lambda_normal", "lambda_dssim"):
        assert OPT[k] == getattr(defaults, k)
    assert OPT == {"position_lr_init": 0.00016,
                   "position_lr_final": 0.0000016,
                   "position_lr_max_steps": 30_000, "feature_lr": 0.0025,
                   "opacity_lr": 0.05, "scaling_lr": 0.005,
                   "rotation_lr": 0.001, "lambda_dssim": 0.2,
                   "lambda_normal": 0.05, "lambda_dist": 0.0}
    for name in ("m360-outdoor", "m360-indoor"):
        assert loss_weights(_config(name)) == {}
    assert loss_weights(_config("dtu-object")) == {"lambda_dist": 1000.0}
    for key in ("lambda_distortion", "lambda_normal"):
        cfg = _config("dtu-object")
        cfg["optimization"][key] = 10.0
        with pytest.raises(ValueError, match=key):
            loss_weights(cfg)


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
