"""The compositing kernels' conservative skips, through their plain twins.

K1 and K2 (gs2d_torch/csrc/raster_common.cuh) leave out (record, pixel)
pairs before the exact alpha test, per warp row (``row_may_hit``) and per
pixel (``skip_pair``). That is allowed only where the exact test of
``rasterize_fwd_reference`` rejects the pair as well. The twins in
ops/rasterize/common.py repeat the kernels' float32 operations; here they
meet pairs built to sit at the cutoff (seeded numpy, drawn by hypothesis:
opacities from 1/255 to 0.99, p2 from 1e-13 up, NaN fields), and the
records of small scenes at reset-level opacities, where the plain versions
must still match the JAX package at the bars of tests/test_torch_rasterize.py
(2e-4) and tests/test_torch_kernel_bwd.py (the gradient bar); at an opacity
just above the cutoff also a float64 run of the plain forward.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gs2d_torch.ops.rasterize import kernel_fwd
from gs2d_torch.ops.rasterize.api import pack_entries, rasterize, untile
from gs2d_torch.ops.rasterize.binning import bin_gaussians
from gs2d_torch.ops.rasterize.common import (ALPHA_CLAMP, ALPHA_CUTOFF,
                                             CULL_MARGIN, FILTER_INV_SQUARE,
                                             TILE_H, TILE_W, cdiv,
                                             row_may_hit, skip_pair,
                                             skip_radius)
from gs2d_torch.ops.rasterize.kernel_bwd import rasterize_bwd_reference
from gs2d_torch.ops.rasterize.kernel_fwd import rasterize_fwd_reference
from gs2d_torch.ops.rasterize.preprocess import preprocess as t_preprocess
from gs2d_tpu.ops.rasterize.api import RasterizeConfig
from gs2d_tpu.ops.rasterize.oracle import rasterize_oracle as j_oracle
from gs2d_tpu.ops.rasterize.preprocess import preprocess as j_preprocess

from .test_torch_common import port_camera
from .test_torch_kernel_bwd import ATOL as GRAD_ATOL
from .test_torch_kernel_bwd import RTOL as GRAD_RTOL
from .test_torch_kernel_bwd import _j_loss, _t_grads, assert_grad_close
from .test_torch_rasterize import _both
from .utils import lookat_camera, random_cloud

SETTINGS = settings(max_examples=30, deadline=None, database=None,
                    derandomize=True)


def exact_test(e, px, py):
    """The per-pair geometry and exact alpha test of
    rasterize_fwd_reference (the near-plane test, which only rejects more,
    left out): (p0, p1, p2, rho2d, kept). e (R, 24); px, py broadcast
    against (R, 1)."""
    def col(k):
        return e[:, k:k + 1]

    p0 = col(0) + px * col(3) + py * col(6)
    p1 = col(1) + px * col(4) + py * col(7)
    p2 = col(2) + px * col(5) + py * col(8)
    p2_ok = torch.abs(p2) > 1e-12
    p2s = torch.where(p2_ok, p2, torch.ones_like(p2))
    u, v = p0 / p2s, p1 / p2s
    rho3d = u * u + v * v
    dx, dy = px - col(12), py - col(13)
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    alpha = torch.clamp(col(14) * torch.exp(-0.5 * torch.minimum(
        rho3d, rho2d)), max=ALPHA_CLAMP)
    return p0, p1, p2, rho2d, p2_ok & (alpha >= ALPHA_CUTOFF)


def boundary_records(seed, n, p2_exp, nan_field, row=False):
    """n records, each with a pixel (px, py) at which rho3d and rho2d lie
    within 1e-4 (relative) of the exact cutoff radius 2 ln(255 opacity) or
    of the skip's threshold, or further off by up to a factor 3; p2 there is
    ±10^p2_exp times a factor in [1, 10). With row=True the pixel lies in
    the warp row [xa, xa + 31] at py, returned as (records, xa, py) with
    one row for all. nan_field: a record field set to NaN in every 7th
    record."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    opac = (10 ** rng.uniform(np.log10(1 / 255), np.log10(0.99), n)).astype(
        f32)
    rex = 2 * np.log(opac.astype(np.float64) * 255)
    if row:
        xa = float(TILE_W * rng.integers(0, 60))
        py = float(rng.integers(0, 1080))
        px = xa + rng.integers(0, TILE_W, n)
        py_n = np.full(n, py)
    else:
        px = rng.integers(0, 1920, n).astype(np.float64)
        py_n = rng.integers(0, 1080, n).astype(np.float64)
    # where rho3d and rho2d sit, each drawn on its own: at the exact
    # cutoff, at the skip's own threshold (the cutoff plus CULL_MARGIN), or
    # anywhere from a third to three times the cutoff
    def rho():
        at = [rex * (1 + rng.uniform(-1e-4, 1e-4, n)),
              (rex + CULL_MARGIN) * (1 + rng.uniform(-1e-4, 1e-4, n)),
              rex * 10 ** rng.uniform(-0.5, 0.5, n)]
        return np.choose(rng.integers(0, 3, n), at) + 1e-6

    rho3, rho2 = rho(), rho()
    ang = rng.uniform(0, 2 * np.pi, n)
    p2 = rng.choice([-1.0, 1.0], n) * 10.0 ** p2_exp * rng.uniform(1, 10, n)
    p = np.stack([np.sqrt(rho3) * np.cos(ang) * p2,
                  np.sqrt(rho3) * np.sin(ang) * p2, p2], axis=1)
    # how fast p moves from pixel to pixel, against p2 (slower along a row,
    # so that whole rows come near the thresholds)
    lo, hi = (-4, -1) if row else (-3, 0)
    scale = 10 ** rng.uniform(lo, hi, (n, 1)) * np.abs(p2)[:, None]
    B = rng.normal(size=(n, 3)) * scale
    C = rng.normal(size=(n, 3)) * scale
    ang2 = rng.uniform(0, 2 * np.pi, n)
    d = np.sqrt(rho2 / FILTER_INV_SQUARE)
    center = np.stack([px - d * np.cos(ang2), py_n - d * np.sin(ang2)], 1)
    if row:
        # half the rows come nearest the origin of (u, v) at the drawn
        # pixel (B moves (p0, p1) across it, p2 fixed) and pass under the
        # centre at the drawn rho2d, so that the row as a whole sits at the
        # thresholds
        perp = rng.random(n) < 0.5
        k = rng.normal(size=n) * 10 ** rng.uniform(-3, 0, n)
        B[perp] = np.stack([-k * p[:, 1], k * p[:, 0], np.zeros(n)],
                           1)[perp]
        center[perp, 0] = px[perp] + rng.uniform(-4, 4, perp.sum())
        center[perp, 1] = py_n[perp] + rng.choice([-1, 1], perp.sum()) \
            * d[perp]
    A = p - px[:, None] * B - py_n[:, None] * C
    e = np.zeros((n, 24))
    e[:, 0:3], e[:, 3:6], e[:, 6:9] = A, B, C
    e[:, 9:12] = rng.normal(size=(n, 3))
    e[:, 12:14] = center
    e[:, 14] = opac
    e = e.astype(f32)
    if nan_field is not None:
        e[::7, nan_field] = np.nan
    e = torch.from_numpy(e)
    if row:
        return e, xa, py
    return e, torch.from_numpy(px.astype(f32))[:, None], \
        torch.from_numpy(py_n.astype(f32))[:, None]


NAN_FIELDS = st.sampled_from([None, 0, 2, 5, 8, 12, 13, 14])


@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), p2_exp=st.integers(-13, 3),
       nan_field=NAN_FIELDS)
def test_skip_pair_keeps_every_pair_the_exact_test_keeps(seed, p2_exp,
                                                         nan_field):
    e, px, py = boundary_records(seed, 4096, p2_exp, nan_field)
    p0, p1, p2, rho2d, kept = exact_test(e, px, py)
    skipped = skip_pair(p0, p1, p2, rho2d, skip_radius(e[:, 14])[:, None])
    assert not (skipped & kept).any()
    if nan_field is None and p2_exp > -12:
        # the cases straddle the cutoff: both outcomes occur
        assert kept.sum() > 1000 and skipped.sum() > 200


@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), p2_exp=st.integers(-13, 3),
       nan_field=NAN_FIELDS)
def test_row_test_keeps_every_row_with_a_kept_pixel(seed, p2_exp,
                                                    nan_field):
    e, xa, py = boundary_records(seed, 2048, p2_exp, nan_field, row=True)
    px = xa + torch.arange(TILE_W, dtype=torch.float32)[None]
    kept = exact_test(e, px, py)[4].any(dim=1)
    may_hit = row_may_hit(e, skip_radius(e[:, 14]), xa, py)
    assert not (kept & ~may_hit).any()
    if nan_field is None and p2_exp > -12:
        assert kept.sum() > 500 and (~may_hit).sum() > 20


def test_radius_edges():
    """r < 0 below the cutoff opacity, NaN for a NaN or negative one; a
    negative r skips every pair, a NaN r none."""
    r = skip_radius(torch.tensor([0.0, 1 / 255 * 0.9, -0.5, float("nan"),
                                  1.0]))
    assert r[0] == -float("inf") and r[1] < 0
    assert torch.isnan(r[2]) and torch.isnan(r[3])
    assert abs(float(r[4]) - (2 * np.log(255.0) + CULL_MARGIN)) < 1e-5
    one = torch.ones(5)
    assert skip_pair(one, one, one, one, r).tolist() == [
        True, True, False, False, False]


def _scene_at_cutoff(opacity, seed=4, n=150, w=128, h=64):
    """A small scene of large splats, every opacity ``opacity`` (None: the
    seeded 0.2-0.95 of random_cloud)."""
    cloud = list(random_cloud(n, seed, scale_lo=0.05, scale_hi=0.4))
    if opacity is not None:
        cloud[3] = np.full(n, opacity, np.float32)
    return tuple(cloud), w, h


@pytest.mark.parametrize("opacity", [0.0045, 0.01])
def test_twins_on_a_scene_at_the_cutoff(opacity):
    """Every (record, pixel) of every tile's list at reset-level opacities:
    no pair the exact test keeps is skipped, no row with such a pair left
    out; and the plain versions' composited counts agree."""
    cloud, w, h = _scene_at_cutoff(opacity)
    _, tp = _both(w, h, cloud)
    b = bin_gaussians(tp.center2d, tp.extent, tp.depth, tp.visible, w, h)
    packed = pack_entries(tp)
    args = (packed, b.gid, b.tile_start, b.tile_count, w, h)
    out, med, nc, comp = rasterize_fwd_reference(*args,
                                                 return_composited=True)
    assert comp > 0 and comp <= int(nc.sum())
    cot = torch.ones_like(out)
    _, comp_bwd = rasterize_bwd_reference(*args[:4], out, cot, med, nc, w, h,
                                          return_composited=True)
    assert comp_bwd == comp
    ntx = cdiv(w, TILE_W)
    n_kept = 0
    for t in range(b.tile_start.numel()):
        s, c = int(b.tile_start[t]), int(b.tile_count[t])
        if c == 0:
            continue
        e = packed[b.gid[s:s + c].long()]
        r = skip_radius(e[:, 14])
        for row in range(TILE_H):
            xa = float((t % ntx) * TILE_W)
            py = float((t // ntx) * TILE_H + row)
            px = xa + torch.arange(TILE_W, dtype=torch.float32)[None]
            p0, p1, p2, rho2d, kept = exact_test(e, px, py)
            assert not (skip_pair(p0, p1, p2, rho2d, r[:, None])
                        & kept).any()
            assert not (kept.any(dim=1) & ~row_may_hit(e, r, xa, py)).any()
            n_kept += int(kept.sum())
    assert n_kept >= comp


@pytest.mark.parametrize("opacity", [None, 0.01])
def test_plain_versions_match_jax(opacity):
    """On a small scene, and at the reset's opacity cap, the plain K1
    (through rasterize) matches the JAX oracle at 2e-4 and gradients
    through the plain K2 match jax.grad through the JAX rasterize at the
    gradient bar."""
    cloud, w, h = _scene_at_cutoff(opacity)
    jp, tp = _both(w, h, cloud)
    img, aux = rasterize(tp, w, h)
    assert aux["num_pairs"] > 0 and float(img[4].max()) > 0
    np.testing.assert_allclose(img.numpy(), np.asarray(j_oracle(jp, w, h)),
                               rtol=2e-4, atol=2e-4)
    n = cloud[0].shape[0]
    arrays = cloud + (np.zeros((n, 2), np.float32),)
    cot = np.random.default_rng(7).normal(size=(15, h, w)).astype(
        np.float32)
    cfg = RasterizeConfig(width=w, height=h, pairs_capacity=1 << 14,
                          chunk=16, interpret=True, cull=False)
    g_jax = jax.grad(_j_loss(lookat_camera(w, h), cfg, jnp.asarray(cot)),
                     argnums=tuple(range(7)))(
                         *(jnp.asarray(x) for x in arrays))
    g_port = _t_grads(arrays, w, h, torch.from_numpy(cot), cull=False)
    names = ["means", "scales", "quats", "opac", "rgb", "noise", "offsets"]
    for name, a, b in zip(names, g_jax, g_port):
        assert_grad_close(b.numpy(), a, name)


def _fwd_reference_float64():
    """rasterize_fwd_reference as its module writes it, with its float32
    dtypes made float64 and without its input checks (which require
    float32): the same operations in double precision."""
    src = inspect.getsource(kernel_fwd)
    edits = {"dtype=torch.float32": "dtype=packed.dtype",
             "to(torch.float32)": "to(packed.dtype)"}
    for old, new in edits.items():
        assert src.count(old) >= 2, old
        src = src.replace(old, new)
    ns = {"__name__": "fwd64", "__package__": kernel_fwd.__package__}
    exec(compile(src, kernel_fwd.__file__, "exec"), ns)
    ns["_check_inputs"] = lambda packed, gid, start, *_: start.shape[0]
    return ns["rasterize_fwd_reference"]


def _grads_float64(arrays, w, h, cot):
    """Gradients of sum(out * cot) in float64, by autograd through the port's
    preprocess and the float64 plain forward."""
    cam = port_camera(w, h)
    ps = [torch.as_tensor(x, dtype=torch.float64).requires_grad_()
          for x in arrays]
    means, scales, quats, opac, rgb, noise, offsets = ps
    f64 = [x.to(torch.float64) for x in (cam.world_view, cam.full_proj,
                                         cam.campos)]
    pre = t_preprocess(means, scales, quats, opac, *f64, w, h, colors=rgb,
                       noise=noise, screen_offsets=offsets)
    b = bin_gaussians(pre.center2d, pre.extent, pre.depth, pre.visible, w, h)
    out, _, _ = _fwd_reference_float64()(pack_entries(pre), b.gid,
                                         b.tile_start, b.tile_count, w, h)
    img = untile(out, w, h)
    return torch.autograd.grad((img * cot.to(torch.float64)).sum(), ps)


def test_gradients_at_opacity_just_above_the_cutoff():
    """Every opacity 0.0045 (alpha >= 1/255 only where G > 0.87). The plain
    K1 (through rasterize) matches the JAX oracle at 2e-4, and gradients
    through the plain K2 match jax.grad through the JAX oracle and a
    float64 run of the plain forward at the gradient bar. Against jax.grad
    through the JAX package's Pallas K2 (interpret mode) a few d scales
    values miss the bar; on every such value the float64 run lies nearer
    the port than the Pallas kernel (the Pallas kernel's float32 rounding,
    ROADMAP queue 3)."""
    cloud, w, h = _scene_at_cutoff(0.0045)
    jp, tp = _both(w, h, cloud)
    img, aux = rasterize(tp, w, h)
    assert aux["num_pairs"] > 0 and float(img[4].max()) > 0
    np.testing.assert_allclose(img.numpy(), np.asarray(j_oracle(jp, w, h)),
                               rtol=2e-4, atol=2e-4)
    n = cloud[0].shape[0]
    arrays = cloud + (np.zeros((n, 2), np.float32),)
    cot = np.random.default_rng(7).normal(size=(15, h, w)).astype(
        np.float32)
    jcam = lookat_camera(w, h)
    jcot = jnp.asarray(cot)

    def oracle_loss(means, scales, quats, opac, rgb, noise, offsets):
        pre = j_preprocess(means, scales, quats, opac, jcam.world_view,
                           jcam.full_proj, jcam.campos, w, h, colors=rgb,
                           noise=noise, screen_offsets=offsets)
        return jnp.sum(j_oracle(pre, w, h) * jcot)

    cfg = RasterizeConfig(width=w, height=h, pairs_capacity=1 << 14,
                          chunk=16, interpret=True, cull=False)
    jargs = [jnp.asarray(x) for x in arrays]
    argnums = tuple(range(7))
    g_oracle = jax.grad(oracle_loss, argnums=argnums)(*jargs)
    g_pallas = jax.grad(_j_loss(jcam, cfg, jcot), argnums=argnums)(*jargs)
    g_port = _t_grads(arrays, w, h, torch.from_numpy(cot), cull=False)
    g_64 = _grads_float64(arrays, w, h, torch.from_numpy(cot))
    names = ["means", "scales", "quats", "opac", "rgb", "noise", "offsets"]
    for name, orc, pal, port, ref64 in zip(names, g_oracle, g_pallas, g_port,
                                           g_64):
        port, ref64, pal = port.numpy(), ref64.numpy(), np.asarray(pal)
        assert_grad_close(port, orc, f"{name} against the JAX oracle")
        assert_grad_close(port, ref64, f"{name} against float64")
        scale = max(np.abs(pal).max(), 1e-6)
        off = np.abs(port - pal) / scale > GRAD_ATOL + GRAD_RTOL * np.abs(
            pal) / scale
        assert (np.abs(ref64 - port) < np.abs(ref64 - pal))[off].all(), name
