"""Port parity of the training slice: the image losses, the LR schedule,
Adam, the densification statistics and one whole ``train_step``, against
the JAX package on the same seeded NumPy inputs (its Pallas kernels in
interpret mode, un-culled, chunk 16), plus an overfit run on the CPU.

Bars: 1e-6 for the losses and Adam (float32 maths in the same order),
1e-7 relative for the LR schedule, exact for the densification
statistics, and the gradient bar of tests/test_rasterize_bwd.py:50-57
(rtol 1e-3 / atol 5e-4 on values normalised by each field's largest
magnitude) for gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_torch.config import OptimizationParams as TOptParams
from gs2d_torch.models.densify import add_densification_stats as t_stats
from gs2d_torch.models.gaussians import GaussianParams as TParams
from gs2d_torch.models.gaussians import GaussianState as TState
from gs2d_torch.models.gaussians import state_from_numpy
from gs2d_torch.ops import ssim as t_ssim
from gs2d_torch.ops.rasterize.api import rasterize as t_rasterize
from gs2d_torch.ops.sh import rgb_to_sh
from gs2d_torch.render.renderer import prepare
from gs2d_torch.render.renderer import render as t_render
from gs2d_torch.train.optim import AdamState as TAdam
from gs2d_torch.train.optim import adam_step as t_adam_step
from gs2d_torch.train.optim import init_adam as t_init_adam
from gs2d_torch.train.optim import make_lrs as t_make_lrs
from gs2d_torch.train.step import TrainState as TTrainState
from gs2d_torch.train.step import loss_and_grads
from gs2d_torch.train.step import make_train_step as t_make_train_step
from gs2d_torch.utils.general import expon_lr as t_expon_lr
from gs2d_tpu.config import OptimizationParams as JOptParams
from gs2d_tpu.models.densify import add_densification_stats as j_stats
from gs2d_tpu.models.gaussians import GaussianParams as JParams
from gs2d_tpu.models.gaussians import GaussianState as JState
from gs2d_tpu.ops import ssim as j_ssim
from gs2d_tpu.ops.rasterize.api import RasterizeConfig
from gs2d_tpu.render.renderer import render as j_render
from gs2d_tpu.train.optim import AdamState as JAdam
from gs2d_tpu.train.optim import adam_step as j_adam_step
from gs2d_tpu.train.optim import init_adam as j_init_adam
from gs2d_tpu.train.optim import make_lrs as j_make_lrs
from gs2d_tpu.train.step import TrainState as JTrainState
from gs2d_tpu.train.step import make_train_step as j_make_train_step
from gs2d_tpu.utils.general import expon_lr as j_expon_lr

from .test_torch_common import port_camera, to_t
from .test_torch_kernel_bwd import assert_grad_close
from .utils import lookat_camera, random_cloud

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
W, H = 64, 32


def _images(seed, c=3, h=H, w=W):
    rng = np.random.default_rng(seed)
    a = rng.random((c, h, w), np.float32)
    b = np.clip(a + rng.normal(scale=0.2, size=a.shape), 0, 1) \
        .astype(np.float32)
    return a, b


def test_image_losses_match_jax():
    a, b = _images(0)
    for name in ("ssim", "l1_loss", "l2_loss", "psnr"):
        got = float(getattr(t_ssim, name)(to_t(a), to_t(b)))
        ref = float(getattr(j_ssim, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    d = np.random.default_rng(1).random((1, H, W), np.float32)
    np.testing.assert_allclose(
        float(t_ssim.smooth_loss(to_t(d), to_t(a))),
        float(j_ssim.smooth_loss(jnp.asarray(d), jnp.asarray(a))),
        rtol=1e-6, atol=1e-6)


def test_ssim_gradient_matches_jax():
    a, b = _images(2)
    ta = to_t(a).requires_grad_()
    t_ssim.ssim(ta, to_t(b)).backward()
    ref = jax.grad(j_ssim.ssim)(jnp.asarray(a), jnp.asarray(b))
    assert_grad_close(ta.grad.numpy(), ref, "d ssim / d img1")


@pytest.mark.parametrize("kw", [
    dict(lr_init=0.00016, lr_final=0.0000016, lr_delay_mult=0.01,
         max_steps=30_000),
    dict(lr_init=0.01, lr_final=0.001, lr_delay_steps=500,
         lr_delay_mult=0.1, max_steps=10_000),
    dict(lr_init=0.0, lr_final=0.0)])
def test_expon_lr_matches_jax(kw):
    for step in (0, 1, 250, 499, 500, 7999, 8000, 29_999, 30_000, 45_000):
        got = t_expon_lr(step, **kw)
        ref = float(j_expon_lr(step, **kw))
        assert abs(got - ref) <= 1e-7 * abs(ref), (step, got, ref)


def _rand_params(rng, n, cls, conv):
    shapes = {"xyz": (n, 3), "features_dc": (n, 1, 3),
              "features_rest": (n, 15, 3), "scaling": (n, 2),
              "rotation": (n, 4), "opacity": (n, 1)}
    arrs = {f: rng.normal(size=s).astype(np.float32)
            for f, s in shapes.items()}
    return arrs, cls(**{f: conv(v) for f, v in arrs.items()})


def test_adam_step_matches_jax():
    rng = np.random.default_rng(3)
    n = 40
    p, jp = _rand_params(rng, n, JParams, jnp.asarray)
    m, jm = _rand_params(rng, n, JParams, lambda x: jnp.asarray(x * 1e-3))
    v = {f: np.abs(x) * 1e-6 for f, x in
         _rand_params(rng, n, JParams, jnp.asarray)[0].items()}
    j_opt = JAdam(mu=jm, nu=JParams(**{f: jnp.asarray(x)
                                       for f, x in v.items()}),
                  step=jnp.int32(6))
    t_opt = TAdam(mu=TParams(**{f: to_t(x * 1e-3) for f, x in m.items()}),
                  nu=TParams(**{f: to_t(x) for f, x in v.items()}), step=6)
    tp = TParams(**{f: to_t(x) for f, x in p.items()})
    for k in range(3):
        g, jg = _rand_params(rng, n, JParams, jnp.asarray)
        jlrs = j_make_lrs(jnp.float32(1.6e-4 / (k + 1)))
        tlrs = t_make_lrs(float(np.float32(1.6e-4 / (k + 1))))
        jp, j_opt = j_adam_step(jp, jg, j_opt, jlrs, jnp.ones(n, bool))
        tp, t_opt = t_adam_step(tp, TParams(**{f: to_t(x)
                                               for f, x in g.items()}),
                                t_opt, tlrs)
        assert t_opt.step == int(j_opt.step)
        for f in FIELDS:
            for got, ref in ((tp, jp), (t_opt.mu, j_opt.mu),
                             (t_opt.nu, j_opt.nu)):
                np.testing.assert_allclose(
                    getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                    rtol=1e-6, atol=1e-6, err_msg=f)
    fresh = t_init_adam(tp)
    assert fresh.step == 0 and all(
        (getattr(fresh.mu, f) == 0).all() for f in FIELDS)


def test_densification_stats_match_jax():
    rng = np.random.default_rng(4)
    n = 50
    grads = rng.normal(scale=1e-3, size=(n, 2)).astype(np.float32)
    radii = rng.integers(0, 4, n).astype(np.int32)
    mr = rng.random(n, np.float32) * 3
    ga = rng.random(n, np.float32)
    dn = rng.integers(0, 5, n).astype(np.float32)
    _, jparams = _rand_params(rng, n, JParams, jnp.asarray)
    js = JState(params=jparams, active=jnp.ones(n, bool),
                active_sh_degree=jnp.int32(3), max_radii2d=jnp.asarray(mr),
                grad_accum=jnp.asarray(ga), denom=jnp.asarray(dn))
    js = j_stats(js, jnp.asarray(grads), jnp.asarray(radii), 96, 48)
    _, tparams = _rand_params(rng, n, TParams, to_t)
    ts = TState(params=tparams, active_sh_degree=3, max_radii2d=to_t(mr),
                grad_accum=to_t(ga), denom=to_t(dn))
    ts = t_stats(ts, to_t(grads), to_t(radii), 96, 48)
    for f in ("max_radii2d", "grad_accum", "denom"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


# --- one whole step against the JAX package ---------------------------------

def _jax_state(n=100, cap=112, seed=21):
    means, scales, quats, opac, rgb, _ = random_cloud(n, seed)
    rng = np.random.default_rng(seed)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    fields = dict(
        xyz=pad(means), features_dc=pad(rgb_to_sh(rgb)[:, None, :]),
        features_rest=pad((rng.normal(size=(n, 15, 3)) * 0.1)
                          .astype(np.float32)),
        scaling=pad(np.log(scales)), rotation=pad(quats, 1.0),
        opacity=pad(np.log(opac / (1 - opac))[:, None]))
    stats = dict(max_radii2d=pad(rng.random(n, np.float32)),
                 grad_accum=pad(rng.random(n, np.float32) * 1e-2),
                 denom=pad(rng.integers(0, 9, n).astype(np.float32)))
    active = np.arange(cap) < n
    active[5] = False                      # a hole inside the live range
    state = JState(
        params=JParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
        active=jnp.asarray(active), active_sh_degree=jnp.int32(3),
        **{k: jnp.asarray(v) for k, v in stats.items()})
    return state, fields, stats, active


def _j_loss_fn(state, cam, rcfg, gt, it, bg, opt_cfg, depth_ratio):
    """The loss of gs2d_tpu/train/step.py:68-96, from the JAX package's
    render, l1_loss and ssim."""
    def loss_fn(params, offsets):
        pkg = j_render(cam, dataclasses.replace(state, params=params), rcfg,
                       bg, max_sh_degree=3, screen_offsets=offsets,
                       depth_ratio=depth_ratio)
        image = pkg["render"]
        ll1 = j_ssim.l1_loss(image, gt)
        ssim_v = j_ssim.ssim(image, gt)
        base = ((1.0 - opt_cfg.lambda_dssim) * ll1
                + opt_cfg.lambda_dssim * (1.0 - ssim_v))
        lam_n = opt_cfg.lambda_normal if it > 7000 else 0.0
        lam_d = opt_cfg.lambda_dist if it > 3000 else 0.0
        normal_err = 1.0 - jnp.sum(pkg["rend_normal"] * pkg["surf_normal"],
                                   axis=0)
        return (base + lam_n * jnp.mean(normal_err)
                + lam_d * jnp.mean(pkg["rend_dist"]))
    return loss_fn


STEP_CASES = [(1, {}, 0.0), (8000, {"lambda_dist": 10.0}, 1.0)]


@pytest.fixture(scope="module", params=STEP_CASES,
                ids=["iter1-defaults", "iter8000-dist10-median"])
def step_pair(request):
    it, opt_kw, depth_ratio = request.param
    state, fields, stats, active = _jax_state()
    gt = np.random.default_rng(1).random((3, H, W), np.float32)
    bg = np.zeros(3, np.float32)
    rcfg = RasterizeConfig(width=W, height=H, pairs_capacity=1 << 13,
                           chunk=16, interpret=True, cull=False)
    j_opt_cfg = JOptParams(**opt_kw)
    jcam = lookat_camera(W, H)
    j_step = j_make_train_step(rcfg, j_opt_cfg, max_sh_degree=3,
                               depth_ratio=depth_ratio)
    j_opt = j_init_adam(state.params)
    j_ts, j_m = j_step(JTrainState(gaussians=state, opt=j_opt,
                                   key=jax.random.PRNGKey(0)),
                       jcam, jnp.asarray(gt), jnp.int32(it), jnp.asarray(bg))
    ramp = dataclasses.replace(state, active_sh_degree=jnp.int32(
        min(it // 1000, 3)))
    j_total, (j_gp, j_goff) = jax.value_and_grad(
        _j_loss_fn(ramp, jcam, rcfg, jnp.asarray(gt), it, jnp.asarray(bg),
                   j_opt_cfg, depth_ratio), argnums=(0, 1))(
        state.params, jnp.zeros((active.shape[0], 2), jnp.float32))

    # the port, from the same state and Adam moments
    t_state = state_from_numpy(**fields, **stats, active=active,
                               active_sh_degree=3, device="cpu")
    t_opt = TAdam(mu=TParams(**{f: to_t(np.asarray(getattr(j_opt.mu, f))
                                          [active]) for f in FIELDS}),
                  nu=TParams(**{f: to_t(np.asarray(getattr(j_opt.nu, f))
                                          [active]) for f in FIELDS}),
                  step=int(j_opt.step))
    t_opt_cfg = TOptParams(**opt_kw)
    tcam = port_camera(W, H)
    t_step = t_make_train_step(t_opt_cfg, max_sh_degree=3,
                               depth_ratio=depth_ratio, device="cpu")
    t_ts, t_m = t_step(TTrainState(gaussians=t_state, opt=t_opt), tcam,
                       to_t(gt), it, to_t(bg))
    t_ramp = dataclasses.replace(t_state, active_sh_degree=min(it // 1000, 3))
    t_grads = loss_and_grads(t_ramp, tcam, to_t(gt), it, to_t(bg), t_opt_cfg,
                             max_sh_degree=3, depth_ratio=depth_ratio,
                             device="cpu")
    with torch.no_grad():
        out, _ = t_rasterize(prepare(tcam, t_ramp), W, H)
    lam_d = t_opt_cfg.lambda_dist if it > 3000 else 0.0
    return dict(it=it, active=active, j_ts=j_ts, j_m=j_m, j_total=j_total,
                j_gp=j_gp, j_goff=j_goff, t_ts=t_ts, t_m=t_m,
                t_grads=t_grads, lrs=j_make_lrs(j_m["xyz_lr"]),
                dist_scale=lam_d * float(torch.mean(out[4] * out[14])))


def test_step_losses_match_jax(step_pair):
    """Every loss term within 1e-5 relative. The distortion term is
    λ·mean(S0·M2 − M1²), a difference four orders of magnitude below its
    operands on this scene, so float32 sums taken in another order move it
    by ~1e-4 of itself: it is held at 1e-5 of λ·mean(S0·M2) instead."""
    j_m, t_m = step_pair["j_m"], step_pair["t_m"]
    for k in ("total_loss", "l1", "ssim", "loss", "dist_loss",
              "normal_loss"):
        got, ref = float(t_m[k]), float(j_m[k])
        scale = max(abs(ref), step_pair["dist_scale"]) \
            if k == "dist_loss" else abs(ref)
        assert abs(got - ref) <= 1e-5 * scale, (k, got, ref)
    np.testing.assert_allclose(float(step_pair["t_grads"][0]),
                               float(step_pair["j_total"]), rtol=1e-5)
    assert t_m["num_pairs"] == int(j_m["num_pairs"]) > 0
    assert t_m["num_points"] == int(j_m["num_points"])
    np.testing.assert_allclose(t_m["xyz_lr"], float(j_m["xyz_lr"]),
                               rtol=1e-7)


def test_step_gradients_match_jax(step_pair):
    act = step_pair["active"]
    _, _, t_gp, t_goff, _ = step_pair["t_grads"]
    for f in FIELDS:
        assert_grad_close(getattr(t_gp, f).numpy(),
                          np.asarray(getattr(step_pair["j_gp"], f))[act], f)
    assert_grad_close(t_goff.numpy(), np.asarray(step_pair["j_goff"])[act],
                      "screen offsets")


def test_step_updates_match_jax(step_pair):
    """Updated parameters within 1e-6 wherever the JAX gradient is above
    1e-3 of its field's largest magnitude; elsewhere a sign flip of a
    near-zero gradient may move a first Adam step by up to 2·lr."""
    act = step_pair["active"]
    t_p = step_pair["t_ts"].gaussians.params
    j_p = step_pair["j_ts"].gaussians.params
    for f in FIELDS:
        got = getattr(t_p, f).numpy()
        ref = np.asarray(getattr(j_p, f))[act]
        g = np.abs(np.asarray(getattr(step_pair["j_gp"], f))[act])
        if g.max() == 0:     # e.g. SH rest below the ramp: no update at all
            np.testing.assert_array_equal(got, ref, err_msg=f)
            continue
        strong = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[strong], ref[strong], rtol=1e-6,
                                   atol=1e-6, err_msg=f)
        lr = float(getattr(step_pair["lrs"], f))
        assert np.abs(got - ref).max() <= 2 * lr * (1 + 1e-5), f
    assert step_pair["t_ts"].opt.step == int(step_pair["j_ts"].opt.step)


def test_step_densification_stats_match_jax(step_pair):
    act = step_pair["active"]
    t_g, j_g = step_pair["t_ts"].gaussians, step_pair["j_ts"].gaussians
    for f in ("max_radii2d", "grad_accum", "denom"):
        assert_grad_close(getattr(t_g, f).numpy(),
                          np.asarray(getattr(j_g, f))[act], f)


def test_overfit_decreases_loss_cpu():
    """CPU twin of tests/test_train_smoke.py: 30 port steps overfit a tiny
    scene (a render of a "true" Gaussian set) from jittered points."""
    cam = port_camera(W, H, dist=4.0)
    means, scales, quats, opac, rgb, _ = random_cloud(
        30, 5, spread=0.8, scale_lo=0.1, scale_hi=0.3)
    n = means.shape[0]

    def state(xyz, colors, rot, logit):
        return TState(params=TParams(
            xyz=to_t(xyz), features_dc=to_t(rgb_to_sh(colors)[:, None, :]),
            features_rest=torch.zeros((n, 15, 3)),
            scaling=to_t(np.log(scales)), rotation=to_t(rot),
            opacity=to_t(logit)), active_sh_degree=0)

    logit = np.log(opac / (1 - opac)).astype(np.float32)[:, None]
    bg = torch.zeros(3)
    gt = t_render(cam, state(means, rgb, quats, logit), bg,
                  device="cpu")["render"].detach()

    rng = np.random.default_rng(7)
    init_pts = means + rng.normal(scale=0.05, size=means.shape).astype(
        np.float32)
    learner = state(init_pts, rgb * 0.5 + 0.25,
                    np.random.default_rng(1).random((n, 4), np.float32),
                    np.full((n, 1), np.log(0.1 / 0.9), np.float32))
    step = t_make_train_step(TOptParams(position_lr_init=0.002,
                                        position_lr_final=0.0002),
                             max_sh_degree=3, device="cpu")
    ts = TTrainState(gaussians=learner, opt=t_init_adam(learner.params))
    losses = []
    for it in range(1, 31):
        ts, metrics = step(ts, cam, gt, it, bg)
        losses.append(float(metrics["total_loss"]))
    assert losses[-1] < losses[0] * 0.7, losses
    assert np.isfinite(losses).all()
    assert (ts.gaussians.denom > 0).any()


def test_train_step_refuses_tensors_off_its_device():
    step = t_make_train_step(TOptParams(), device="cuda")
    cam = port_camera(W, H)
    _, fields, _, active = _jax_state(n=10, cap=10)
    st = state_from_numpy(**fields, active=active, active_sh_degree=3,
                          device="cpu")
    with pytest.raises(ValueError, match="train_step on cuda"):
        step(TTrainState(gaussians=st, opt=t_init_adam(st.params)), cam,
             torch.zeros((3, H, W)), 1, torch.zeros(3))
