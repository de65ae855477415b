"""The render's preprocess as one Function (``preprocess_packed``) on the
CPU, where it runs its plain versions, against the path it replaced: the
activation, the SH mask, ``preprocess`` and ``pack_entries`` under
autograd.

Bars: the plain forward's record and aux equal that path's bit for bit;
the plain analytic backward within 1e-5 of ``torch.autograd.grad``
through it, on values normalised by each leaf's largest magnitude (the
same float32 gradient, summed in another order); ``render()`` and
``loss_and_grads`` within the JAX-parity bars of
``tests/test_torch_render.py`` (2e-4) and ``tests/test_torch_train_step.py``
(rtol 1e-3 / atol 5e-4 normalised).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gs2d_torch.config import OptimizationParams
from gs2d_torch.models.gaussians import GaussianParams, GaussianState
from gs2d_torch.ops.rasterize.api import bin_preprocessed
from gs2d_torch.ops.rasterize.preprocess import (
    pack_entries, preprocess, preprocess_bwd, preprocess_bwd_reference,
    preprocess_fwd, preprocess_packed)
from gs2d_torch.render import renderer
from gs2d_torch.train.step import loss_and_grads

from .test_torch_common import (one_torch_thread,  # noqa: F401
                                port_camera, tile_lists, to_t)
from .utils import lookat_camera, random_cloud

W, H = 64, 48
AUX = ("depth", "extent", "radii", "visible", "rho2max")
LEAVES = ("xyz", "scaling", "rotation", "opacity", "features_dc",
          "features_rest", "colors", "noise", "screen_offsets")

# name: (max SH degree or None for colors, active degree, offsets, noise,
#        scale modifier, spread, rows forced non-finite)
MODES = {
    "colors": (None, 0, False, True, 1.0, 1.0, ()),
    "sh0": (0, 0, False, False, 1.0, 1.0, ()),
    "sh1": (1, 1, False, False, 1.0, 1.0, ()),
    "sh2": (2, 2, False, False, 1.0, 1.0, ()),
    "sh3": (3, 3, False, False, 1.0, 1.0, ()),
    "sh4": (4, 4, False, False, 1.0, 1.0, ()),
    "sh3_active1": (3, 1, False, False, 1.0, 1.0, ()),
    "sh2_offsets_noise": (2, 2, True, True, 1.0, 1.0, ()),
    "sh3_modifier": (3, 3, True, False, 0.7, 1.0, ()),
    "sh3_wide": (3, 2, True, True, 1.0, 6.0, ()),
    "sh3_nonfinite": (3, 3, True, True, 1.0, 1.0, (3, 17)),
}


def _inputs(mode, n=240, seed=0):
    """Raw parameters (log-scales, logits), the camera and the flags."""
    deg, active, offsets, noise, smod, spread, bad = MODES[mode]
    means, scales, quats, opac, rgb, nz = random_cloud(
        n, seed + sum(map(ord, mode)), spread=spread)
    rng = np.random.default_rng(seed + 7)
    cam = port_camera(W, H)
    t = torch.as_tensor
    p = {"xyz": t(means), "scaling": t(np.log(scales)),
         "rotation": t(quats * rng.uniform(0.5, 2.0, (n, 1)).astype(
             np.float32)),
         "opacity": t(np.log(opac / (1 - opac))[:, None])}
    if deg is None:
        p["colors"] = t(rgb)
    else:
        K = (deg + 1) ** 2
        p["features_dc"] = t(((rgb - 0.5) / 0.28209479177387814)[:, None])
        p["features_rest"] = t((rng.normal(size=(n, K - 1, 3)) * 0.3)
                               .astype(np.float32))
    if noise:
        p["noise"] = t(nz)
    if offsets:
        p["screen_offsets"] = t(rng.normal(size=(n, 2)).astype(np.float32))
    if bad:
        # a noise row whose record is non-finite, and an SH coefficient
        # that makes another row's colour non-finite
        p["noise"][bad[0], 1] = math.inf
        p["features_rest"][bad[1], 2, 0] = math.inf
    kw = {"sh_degree": active, "scale_modifier": smod}
    return p, cam, kw


def _old_path(p, cam, sh_degree, scale_modifier):
    """The render's preprocess as it was: activation, SH mask,
    ``preprocess``, ``pack_entries``, under autograd."""
    shs, deg = None, 0
    if "colors" not in p:
        shs = torch.cat([p["features_dc"], p["features_rest"]], dim=1)
        K = shs.shape[1]
        deg = math.isqrt(K) - 1
        kdeg = torch.floor(torch.sqrt(torch.arange(K, dtype=torch.float32)))
        shs = shs * (kdeg <= sh_degree).to(torch.float32)[:, None]
    pre = preprocess(p["xyz"], torch.exp(p["scaling"]), p["rotation"],
                     torch.sigmoid(p["opacity"])[:, 0], cam.world_view,
                     cam.full_proj, cam.campos, cam.width, cam.height,
                     sh_degree=deg, shs=shs, colors=p.get("colors"),
                     scale_modifier=scale_modifier,
                     screen_offsets=p.get("screen_offsets"),
                     noise=p.get("noise"))
    return pack_entries(pre), pre


def _args(p, cam):
    return ([p.get(f) for f in LEAVES]
            + [cam.world_view, cam.full_proj, cam.campos, cam.width,
               cam.height])


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_forward_is_the_old_path_bit_for_bit(mode):
    """The record and the aux as the old path made them, but that a row
    the record zeroes is not ``visible``: binning lists it nowhere."""
    p, cam, kw = _inputs(mode)
    packed, *aux = preprocess_fwd(*_args(p, cam), **kw)
    ref, pre = _old_path(p, cam, **kw)
    assert torch.equal(packed, ref)
    kept = torch.ones(len(ref), dtype=torch.bool)
    kept[list(MODES[mode][6])] = False
    for name, got in zip(AUX, aux):
        want = getattr(pre, name)
        if name == "visible":
            want = want & kept
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert int(pre.visible.sum()) > 0
    if MODES[mode][5] > 1.0:      # the wide cloud: splats behind the camera
        assert not pre.visible.all() and (pre.depth < 0).any()
    if MODES[mode][6]:
        assert not torch.isfinite(torch.cat(
            [pre.A, pre.rgb, pre.noise], 1)[list(MODES[mode][6])]).all()
        assert (packed[list(MODES[mode][6])] == 0).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_backward_matches_autograd(mode):
    """Every leaf's gradient within 1e-5 of autograd's, normalised per
    leaf, for a random cotangent on all 24 columns (the centre's
    included). A row the forward zeroed gets exact zeros; where autograd
    gives NaN there (0·inf through the SH direction), it is left out."""
    p, cam, kw = _inputs(mode)
    leaves = {f: x.clone().requires_grad_() for f, x in p.items()}
    ref_packed, _ = _old_path(leaves, cam, **kw)
    cot = torch.as_tensor(np.random.default_rng(3).normal(
        size=tuple(ref_packed.shape)).astype(np.float32))
    names = list(leaves)
    want = dict(zip(names, torch.autograd.grad(
        ref_packed, [leaves[f] for f in names], cot, allow_unused=True,
        materialize_grads=True)))
    got = dict(zip(LEAVES, preprocess_bwd_reference(cot, *_args(p, cam),
                                                    **kw)))
    bad = list(MODES[mode][6])
    for f in LEAVES:
        if f not in p:
            assert got[f] is None, f
            continue
        g, w = got[f], want[f]
        assert g.shape == w.shape and g.dtype == torch.float32, f
        if bad:
            assert (g[bad] == 0).all(), f
        if not w.numel():
            continue
        ok = torch.isfinite(w.reshape(len(w), -1)).all(dim=1)
        scale = w[ok].abs().max().clamp(min=1e-30)
        err = float(((g - w)[ok].abs() / scale).max())
        assert err <= 1e-5, (f, err)
    if MODES[mode][0] is not None and kw["sh_degree"] < MODES[mode][0]:
        nk = (kw["sh_degree"] + 1) ** 2
        assert (got["features_rest"][:, nk - 1:] == 0).all()


def _state(mode, n=160):
    p, cam, kw = _inputs(mode, n=n, seed=11)
    deg = MODES[mode][0]
    K = 16 if deg is None else (deg + 1) ** 2
    params = GaussianParams(
        xyz=p["xyz"], scaling=p["scaling"], rotation=p["rotation"],
        opacity=p["opacity"],
        features_dc=p.get("features_dc", torch.zeros((n, 1, 3))),
        features_rest=p.get("features_rest", torch.zeros((n, K - 1, 3))))
    return (GaussianState(params, active_sh_degree=kw["sh_degree"]), cam,
            p, kw, 3 if deg is None else deg)


def _old_prepare(camera, state, *, max_sh_degree=3, scaling_modifier=1.0,
                 override_color=None, noise=None, screen_offsets=None):
    p = {f.name: getattr(state.params, f.name)
         for f in dataclasses.fields(state.params)}
    if override_color is not None:
        p = {k: p[k] for k in ("xyz", "scaling", "rotation", "opacity")}
        p["colors"] = override_color
    for k, v in (("noise", noise), ("screen_offsets", screen_offsets)):
        if v is not None:
            p[k] = v
    return _old_path(p, camera, min(state.active_sh_degree, max_sh_degree),
                     scaling_modifier)[1]


def _normalised_close(got, want, what):
    scale = max(float(want.abs().max()), 1e-6)
    torch.testing.assert_close(got / scale, want / scale, rtol=1e-3,
                               atol=5e-4, msg=what)


@pytest.mark.parametrize("mode", ["colors", "sh3", "sh3_active1",
                                  "sh3_modifier"])
def test_render_and_gradients_match_the_old_path(mode, monkeypatch):
    state, cam, p, kw, deg = _state(mode)
    bg = torch.tensor([0.1, 0.2, 0.3])
    rkw = {"max_sh_degree": deg, "scaling_modifier": kw["scale_modifier"],
           "override_color": p.get("colors"), "noise": p.get("noise"),
           "device": "cpu"}
    outs = [renderer.render(cam, state, bg, **rkw)]
    with monkeypatch.context() as m:
        m.setattr(renderer, "prepare", _old_prepare)
        outs.append(renderer.render(cam, state, bg, **rkw))
    assert outs[0]["num_pairs"] == outs[1]["num_pairs"] > 0
    for k in ("render", "rend_alpha", "rend_normal", "rend_dist",
              "surf_depth", "rend_noise"):
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=2e-4,
                                   atol=2e-4, msg=k)
    assert torch.equal(outs[0]["radii"], outs[1]["radii"])
    if mode == "colors":
        return
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(2))
    cfg = OptimizationParams(lambda_dist=10.0)
    grads = []
    for old in (False, True):
        with monkeypatch.context() as m:
            if old:
                m.setattr(renderer, "prepare", _old_prepare)
            grads.append(loss_and_grads(state, cam, gt, 8000, bg, cfg,
                                        max_sh_degree=deg, depth_ratio=1.0,
                                        device="cpu"))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-5,
                               atol=1e-7)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity"):
        _normalised_close(getattr(grads[0][2], f), getattr(grads[1][2], f),
                          f)
    _normalised_close(grads[0][3], grads[1][3], "screen offsets")


def test_zeroed_rows_bin_nowhere_and_the_rest_as_the_jax_package():
    """Two visible surfels whose records are non-finite (an infinite
    noise value, a NaN colour): the JAX package's preprocess and
    un-culled binning list them, K1 skipping their zeroed records; the
    port's lists are the JAX package's with those two ids taken out, and
    their radii (densification's statistics) are the JAX package's."""
    import jax.numpy as jnp

    from gs2d_tpu.ops.rasterize.binning import bin_gaussians as j_bin
    from gs2d_tpu.ops.rasterize.preprocess import preprocess as j_preprocess

    w, h, n = 128, 96, 400
    means, scales, quats, opac, rgb, noise = random_cloud(n, seed=4)
    log_s = torch.log(to_t(scales))
    logit = torch.log(to_t(opac) / (1 - to_t(opac)))[:, None]
    # the JAX package gets the port's activations, so both bin one cloud
    act_s, act_o = torch.exp(log_s).numpy(), torch.sigmoid(logit)[:, 0].numpy()
    jcam = lookat_camera(w, h)

    def j_pre(colors, nz):
        return j_preprocess(
            jnp.asarray(means), jnp.asarray(act_s), jnp.asarray(quats),
            jnp.asarray(act_o), jcam.world_view, jcam.full_proj,
            jcam.campos, w, h, colors=jnp.asarray(colors),
            noise=jnp.asarray(nz))

    dead = [int(i) for i in np.flatnonzero(
        np.asarray(j_pre(rgb, noise).visible))[[0, 5]]]
    noise[dead[0], 2] = math.inf
    rgb[dead[1], 0] = math.nan
    jp = j_pre(rgb, noise)
    jb = j_bin(jp.center2d, jp.extent, jp.depth, jp.visible, w, h,
               1 << 15, 128, cull_abc=None)
    assert not bool(jb.overflow)
    j_lists = tile_lists(jb.gid, jb.tile_start, jb.tile_count)
    j_dead = sum(g in dead for lst in j_lists for g in lst)
    assert all(any(d in lst for lst in j_lists) for d in dead)

    tcam = port_camera(w, h)
    pre = preprocess_packed(to_t(means), log_s, to_t(quats), logit,
                            tcam.world_view, tcam.full_proj, tcam.campos, w,
                            h, colors=to_t(rgb), noise=to_t(noise))
    assert (pre.packed[dead] == 0).all() and not pre.visible[dead].any()
    b = bin_preprocessed(pre, w, h, cull=False)
    assert b.num_pairs == int(jb.num_pairs) - j_dead
    assert tile_lists(b.gid, b.tile_start, b.tile_count) == [
        [g for g in lst if g not in dead] for lst in j_lists]
    radii = to_t(jp.radii)
    assert (radii[dead] > 0).all() and torch.equal(pre.radii[dead],
                                                   radii[dead])


def test_packed_fields_are_views_of_the_record():
    """``preprocess_packed``'s fields are columns of ``packed``, which
    ``pack_entries`` hands on, and a gradient through a field reaches
    the parameters."""
    p, cam, kw = _inputs("sh2_offsets_noise")
    leaves = {f: x.clone().requires_grad_() for f, x in p.items()}
    pre = preprocess_packed(
        leaves["xyz"], leaves["scaling"], leaves["rotation"],
        leaves["opacity"], cam.world_view, cam.full_proj, cam.campos,
        cam.width, cam.height, features_dc=leaves["features_dc"],
        features_rest=leaves["features_rest"], noise=leaves["noise"],
        screen_offsets=leaves["screen_offsets"], **kw)
    assert pack_entries(pre) is pre.packed
    assert pre.A.data_ptr() == pre.packed.data_ptr()
    # a field replaced by one of its own is packed anew, with its values
    A = pre.A.detach().clone().requires_grad_()
    edited = pack_entries(pre._replace(A=A))
    assert edited is not pre.packed and torch.equal(edited, pre.packed)
    assert torch.equal(torch.autograd.grad(edited[:, 0:3].sum(), A)[0],
                       torch.ones_like(A))
    assert torch.equal(pre.rgb, pre.packed[:, 15:18])
    assert torch.equal(pre.center2d, pre.packed[:, 12:14])
    g = torch.autograd.grad(pre.center2d.sum() + pre.A.sum(),
                            list(leaves.values()))
    assert all(torch.isfinite(x).all() for x in g)
    assert float(g[0].abs().sum()) > 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p, cam, kw = _inputs("sh3")
    args = _args(p, cam)
    bad = dict(enumerate(args))
    bad[0] = p["xyz"].double()
    with pytest.raises(ValueError, match="xyz"):
        preprocess_fwd(*bad.values(), **kw)
    bad = dict(enumerate(args))
    bad[2] = p["rotation"].t().contiguous().t()
    with pytest.raises(ValueError, match="rotation"):
        preprocess_fwd(*bad.values(), **kw)
    bad = dict(enumerate(args))
    bad[6] = torch.zeros((p["xyz"].shape[0], 3))
    with pytest.raises(ValueError, match="one of the two"):
        preprocess_fwd(*bad.values(), **kw)
    with pytest.raises(ValueError, match="SH degree"):
        preprocess_fwd(*args, sh_degree=4)
    with pytest.raises(ValueError, match="d_packed"):
        preprocess_bwd(torch.zeros((3, 24)), *args, **kw)
