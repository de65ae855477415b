"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports neither JAX nor gs2d_tpu, so it runs on a machine with
only PyTorch and CUDA (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import json
import math

import numpy as np
import pytest
import torch

from gs2d_torch.config import OptimizationParams
from gs2d_torch.models.gaussians import GaussianParams, GaussianState
from gs2d_torch.ops import gather
from gs2d_torch.ops.rasterize import kernel_bwd, kernel_fwd
from gs2d_torch.ops.rasterize.api import (bin_preprocessed, pack_entries,
                                          rasterize)
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


def test_kernel_matches_plain_version_on_culled_lists(cuda):
    """K1 on the interval-culled lists (the default) against its plain
    version on the same lists; the image equals the un-culled one."""
    cam, (m, s, q, o, c) = _scene(cuda)
    pre = preprocess(m, s, q, o, cam.world_view, cam.full_proj, cam.campos,
                     cam.width, cam.height, colors=c)
    packed = pack_entries(pre)
    outs = []
    for cull in (True, False):
        b = bin_preprocessed(pre, cam.width, cam.height, cull)
        args = (packed, b.gid, b.tile_start, b.tile_count, cam.width,
                cam.height)
        out, med, nc = kernel_fwd.rasterize_fwd(*args)
        outs.append((b.num_pairs, out))
        if cull:
            rout, rmed, rnc = kernel_fwd.rasterize_fwd_reference(*args)
            torch.testing.assert_close(out, rout, rtol=TOL, atol=TOL)
            assert (med == rmed).float().mean() >= 0.999
            assert (nc == rnc).float().mean() >= 0.999
    assert outs[0][0] < outs[1][0]
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=TOL, atol=TOL)


def test_render_cuda_matches_cpu(cuda):
    """The render on the card against the same render on the CPU, at 2e-4.

    ``depth_expected`` is compared on the covered pixels whose value lies
    within the scene's depth range: the nearest and farthest splat centre
    along the view axis, widened by the largest splat extent (3 × the
    largest scale, the surfel's 3σ radius). Outside it lie only pixels
    where an edge-on surfel composites through the low-pass branch, whose
    ray-plane intersection divides by p2 ≈ 0: there the depth (~100 in a
    scene 3–5 units away) amplifies float32 rounding differences of
    preprocess between card and CPU past any fixed bar. At most 0.1% of
    covered pixels may lie outside, the allowance of depth_median flips
    in tests/test_torch_render.py."""
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
    for k in ("render", "rend_alpha", "rend_normal"):
        torch.testing.assert_close(outs[0][k].cpu(), outs[1][k], rtol=TOL,
                                   atol=TOL)
    assert outs[0]["num_pairs"] == outs[1]["num_pairs"]

    z = m @ cam.world_view[:3, 2] + cam.world_view[3, 2]
    reach = 3.0 * float(s.max())
    lo, hi = float(z.min()) - reach, float(z.max()) + reach
    got, ref = outs[0]["depth_expected"].cpu(), outs[1]["depth_expected"]
    covered = outs[1]["rend_alpha"] > 0
    inside = covered & (ref >= lo) & (ref <= hi)
    n_out = int((covered & ~inside).sum())
    print(f"depth_expected: {n_out} of {int(covered.sum())} covered pixels "
          f"outside the scene's depth range [{lo:.3f}, {hi:.3f}]")
    assert n_out <= 1e-3 * int(covered.sum())
    torch.testing.assert_close(got[inside], ref[inside], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("f", [1, 2, 3, 4, 24, 45])
def test_gather_rows_bit_identical(cuda, f):
    """The row-gather kernel copies: bit for bit equal to table[idx] for
    both index types, negative indices and M = 0; out of range raises."""
    g = torch.Generator(device=cuda).manual_seed(f)
    n = 5000
    table = torch.randn((n, f), generator=g, device=cuda)
    for dtype in (torch.int32, torch.int64):
        for m in (0, 1, 1000, 100_000):
            idx = torch.randint(-n, n, (m,), generator=g, device=cuda,
                                dtype=dtype)
            before = gather.gather_rows.launches
            out = gather.gather_rows(table, idx)
            assert gather.gather_rows.launches == before + (m > 0)
            assert out.shape == (m, f) and out.dtype == torch.float32
            assert torch.equal(out, table[idx.long()])
        for bad in (n, -n - 1):
            idx = torch.tensor([0, bad, 1], dtype=dtype, device=cuda)
            with pytest.raises(IndexError):
                gather.gather_rows(table, idx)
    # a table whose rows start off 16-byte boundaries takes the 1-float path
    if f % 4 == 0:
        odd = torch.randn(n * f + 1, generator=g, device=cuda)[1:].view(n, f)
        idx = torch.randint(0, n, (777,), generator=g, device=cuda)
        assert torch.equal(gather.gather_rows(odd, idx), odd[idx])


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


@pytest.mark.parametrize("opacity", [0.0045, 0.01])
def test_kernels_at_the_cutoff(cuda, opacity):
    """Every splat at an opacity just above the alpha cutoff (0.0045) or at
    the reset's cap (0.01), where the kernels' row test and per-pixel skip
    leave out nearly every pair and the kept ones sit at the cutoff: K1's
    n_contrib and med_idx and K2's rows agree with the plain versions at
    the bars of the random scenes above."""
    cam, (m, s, q, o, c) = _scene(cuda, n=1500, seed=5)
    pre = preprocess(m, s * 3.0, q, torch.full_like(o, opacity),
                     cam.world_view, cam.full_proj, cam.campos, cam.width,
                     cam.height, colors=c)
    b = bin_gaussians(pre.center2d, pre.extent, pre.depth, pre.visible,
                      cam.width, cam.height)
    fargs = (pack_entries(pre), b.gid, b.tile_start, b.tile_count,
             cam.width, cam.height)
    out, med, nc = kernel_fwd.rasterize_fwd(*fargs)
    torch.cuda.synchronize()
    rout, rmed, rnc, composited = kernel_fwd.rasterize_fwd_reference(
        *fargs, return_composited=True)
    assert composited > 1000
    torch.testing.assert_close(out, rout, rtol=TOL, atol=TOL)
    assert (med == rmed).float().mean() >= 0.999
    assert (nc == rnc).float().mean() >= 0.999
    cot = torch.as_tensor(np.random.default_rng(2).normal(
        size=tuple(out.shape)).astype(np.float32), device=cuda)
    args = fargs[:4] + (out, cot, med, nc, cam.width, cam.height)
    d = kernel_bwd.rasterize_bwd(*args)
    ref = kernel_bwd.rasterize_bwd_reference(*args)
    for sl in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12),
               slice(12, 13), slice(13, 16), slice(16, 19), slice(19, 22)):
        _grad_bar(d[:, sl], ref[:, sl], f"columns {sl}")
    assert torch.equal(kernel_bwd.rasterize_bwd(*args), d)


def test_unaligned_records_are_copied_by_the_wrappers(cuda):
    """A record table that does not start on a 16-byte boundary, which the
    kernels' 16-byte copies cannot stage, is copied by the wrappers first:
    the same outputs as from an aligned copy of it."""
    cam, (m, s, q, o, c) = _scene(cuda, n=400, seed=6)
    pre = preprocess(m, s, q, o, cam.world_view, cam.full_proj, cam.campos,
                     cam.width, cam.height, colors=c)
    b = bin_gaussians(pre.center2d, pre.extent, pre.depth, pre.visible,
                      cam.width, cam.height)
    packed = pack_entries(pre)
    odd = torch.empty(packed.numel() + 1, device=cuda)[1:].view_as(packed)
    odd.copy_(packed)
    assert odd.data_ptr() % 16 != 0
    rest = (b.gid, b.tile_start, b.tile_count, cam.width, cam.height)
    got, want = kernel_fwd.rasterize_fwd(odd, *rest), \
        kernel_fwd.rasterize_fwd(packed, *rest)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    cot = torch.ones_like(want[0])
    bargs = (want[0], cot, want[1], want[2], cam.width, cam.height)
    assert torch.equal(kernel_bwd.rasterize_bwd(odd, *rest[:3], *bargs),
                       kernel_bwd.rasterize_bwd(packed, *rest[:3], *bargs))


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


def test_spans_on_the_card(cuda, tmp_path):
    """A traced step on the card: every stage's span once, the backward's
    (opened on autograd's thread) under ``step.backward``, device times
    from the span's events, resolved after the step with no sync inside
    it, and a device self time within its total."""
    from gs2d_torch.utils import trace
    cam, state = _state(cuda)
    gt = torch.rand((3, cam.height, cam.width), device=cuda)
    bg = torch.zeros(3, device=cuda)
    step = make_train_step(OptimizationParams(), device=cuda)
    ts = TrainState(gaussians=state, opt=init_adam(state.params))
    step(ts, cam, gt, 8000, bg)
    trace.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        step(ts, cam, gt, 8000, bg)
    torch.cuda.synchronize()
    s = trace.summary()
    assert {k: v["calls"] for k, v in s["spans"].items()} == {
        k: 1 for k in ("render", "render.prepare", "raster.bin",
                       "raster.composite_fwd", "render.bridge",
                       "step.losses", "step.backward",
                       "raster.composite_bwd", "raster.reduce",
                       "render.prepare_bwd", "step.update")}
    trace.write(str(tmp_path / "spans.json"))
    recs = json.loads((tmp_path / "spans.json").read_text())["records"]
    parent = {r["name"]: recs[r["parent"]]["name"] for r in recs
              if r["parent"] is not None}
    assert parent["raster.composite_bwd"] == "step.backward"
    assert parent["render.prepare_bwd"] == "step.backward"
    assert s["counts"]["preprocess.kernel"] == 1
    assert "sync" not in s["spans"]["render.prepare"]["counts"]
    assert parent["raster.reduce"] == "raster.composite_bwd"
    for name, v in s["spans"].items():
        assert v["device_s"] > 0, name
        assert -1e-5 <= v["device_self_s"] <= v["device_s"], name
    assert s["spans"]["step.backward"]["device_s"] \
        >= s["spans"]["raster.composite_bwd"]["device_s"]


def _densify_inputs(dev, n=20_000, seed=3):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    shapes = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (15, 3),
              "scaling": (2,), "rotation": (4,), "opacity": (1,)}
    p = {f: t(rng.normal(size=(n,) + s)) for f, s in shapes.items()}
    p["scaling"] = t(np.log(rng.uniform(0.002, 0.4, (n, 2))))
    denom = rng.integers(0, 6, n)
    state = GaussianState(GaussianParams(**p), active_sh_degree=3,
                          max_radii2d=t(rng.uniform(0, 30, n)),
                          grad_accum=t(denom * rng.uniform(0, 4e-4, n)),
                          denom=t(denom))
    opt = init_adam(state.params)
    opt.mu = GaussianParams(**{f: t(rng.normal(size=x.shape))
                               for f, x in p.items()})
    return state, opt


@pytest.mark.parametrize("max_screen_size", [0.0, 20.0])
def test_densify_cuda_matches_cpu(cuda, max_screen_size):
    """densify_and_prune on the card (every row selection through the
    gather kernel) against the same call on CPU tensors with the same
    noise: equal, except split children's xyz at 1e-6."""
    from gs2d_torch.models.densify import densify_and_prune
    args = (2e-4, 0.05, 2.0, max_screen_size, 0.01)
    s_h, o_h = _densify_inputs("cpu")
    probe = densify_and_prune(s_h, o_h, *args,
                              generator=torch.Generator().manual_seed(0))[2]
    noise = torch.as_tensor(np.random.default_rng(9).normal(
        size=(2 * probe.split, 3)).astype(np.float32))
    ref_s, ref_o, ref_c = densify_and_prune(s_h, o_h, *args, noise=noise)
    s_c, o_c = _densify_inputs(cuda)
    before = gather.gather_rows.launches
    got_s, got_o, got_c = densify_and_prune(s_c, o_c, *args,
                                            noise=noise.to(cuda))
    torch.cuda.synchronize()
    assert got_c == ref_c and ref_c.split > 0 and ref_c.clone > 0
    n_keep = s_h.params.xyz.shape[0] - ref_c.pruned
    # one launch per parameter and moment leaf, one for the split noise
    assert ref_c.children > 0
    assert gather.gather_rows.launches - before == 6 + 12 + 1
    for f in FIELDS:
        a, b = getattr(got_s.params, f).cpu(), getattr(ref_s.params, f)
        if f == "xyz":
            assert torch.equal(a[:n_keep + ref_c.clone], b[:n_keep
                                                            + ref_c.clone])
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(a, b), f
        for mom in ("mu", "nu"):
            assert torch.equal(getattr(getattr(got_o, mom), f).cpu(),
                               getattr(getattr(ref_o, mom), f)), (mom, f)
    for f in ("max_radii2d", "grad_accum", "denom"):
        assert not getattr(got_s, f).any()


def _sphere_depth(eye, W=96, H=96, fov=math.radians(40), r=0.5):
    """A camera at ``eye`` looking at the origin and the analytic depth
    map of a sphere of radius r there (tests/test_mesh.py's views)."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    up0 = np.array([0.0, 0, 1]) if abs(fwd[2]) < 0.9 else np.array([0.0, 1,
                                                                      0])
    right = np.cross(fwd, up0)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], 1)
    f = (W / 2) / math.tan(fov / 2)
    gx, gy = np.meshgrid((np.arange(W) - (W - 1) / 2) / f,
                         (np.arange(H) - (H - 1) / 2) / f, indexing="xy")
    d = np.linalg.norm(eye)
    dirz = 1.0 / np.sqrt(1 + gx ** 2 + gy ** 2)
    disc = (d * dirz) ** 2 - (d * d - r * r)
    depth = np.where(disc > 0, (d * dirz - np.sqrt(np.maximum(disc, 0)))
                     * dirz, 0.0).astype(np.float32)
    return R, -R.T @ eye, fov, f, depth


def test_tsdf_and_marching_match_the_cpu(cuda):
    """TSDF fusion and marching tets on the card against the same calls
    on CPU tensors: tsdf and colour within 1e-5, weights equal, and the
    same mesh: the nearest-vertex map is one to one within 1e-5 and
    carries the CPU faces onto the card's (a vertex whose welding key
    moves with the rounding may change places)."""
    from scipy.spatial import cKDTree
    from gs2d_torch.ops.marching import marching_tets
    from gs2d_torch.ops.tsdf import integrate, make_volume
    vols = {d: make_volume(np.zeros(3), 0.9, 0.02, device=d)
            for d in ("cpu", cuda)}
    color = torch.rand((3, 96, 96), generator=torch.Generator().manual_seed(0))
    for eye in ([2.5, 0, 0], [-2.5, 0, 0], [0, 2.5, 0], [0, -2.5, 0],
                [0, 0, 2.5], [0, 0, -2.5]):
        R, T, fov, f, depth = _sphere_depth(eye)
        for d, vol in vols.items():
            cam = make_camera(R, T, fov, fov, 96, 96, device=d)
            integrate(vol, torch.as_tensor(depth, device=d), color.to(d),
                      cam.world_view, f, f, 96, 96, 0.1, 3.0)
    cpu, card = vols["cpu"], vols[cuda]
    assert torch.equal(card.weight.cpu(), cpu.weight)
    assert torch.allclose(card.tsdf.cpu(), cpu.tsdf, rtol=0, atol=1e-5)
    assert torch.allclose(card.color.cpu(), cpu.color, rtol=0, atol=1e-5)
    meshes = [marching_tets(v.tsdf, v.origin, v.voxel_size,
                            mask=v.weight > 0) for v in (cpu, card)]
    (v0, f0), (v1, f1) = [(v.cpu().numpy(), f.cpu().numpy())
                          for v, f in meshes]
    assert f0.shape[0] > 1000 and v1.shape == v0.shape
    dist, to_card = cKDTree(v1).query(v0)
    assert dist.max() < 1e-5 and len(np.unique(to_card)) == len(v0)
    assert {tuple(f) for f in np.sort(to_card[f0], 1).tolist()} == \
        {tuple(f) for f in np.sort(f1, 1).tolist()}


def test_jpeg_pixel_stages_on_the_card_match_the_cpu(cuda):
    """Every committed JPEG fixture: the pixel stages on the card give the
    bytes they give on the CPU (integer arithmetic), and the PIL decode."""
    import json
    from pathlib import Path

    from gs2d_torch.scene import images, jpeg
    root = Path(__file__).resolve().parent / "fixtures" / "jpeg"
    for name, e in json.loads((root / "index.json").read_text()).items():
        if "decoded" not in e:
            continue
        c = jpeg.read_coefficients(str(root / name))
        on_card = jpeg.pixels(c, cuda)
        assert on_card.device.type == "cuda"
        ref = images.decode_png(str(root / e["decoded"]))
        np.testing.assert_array_equal(on_card.cpu().numpy(), ref)
        np.testing.assert_array_equal(jpeg.pixels(c, "cpu").numpy(), ref)


def test_mask_dilation_on_the_card_matches_the_cpu(cuda):
    from gs2d_torch.eval import dtu
    rng = np.random.default_rng(0)
    mask = (rng.random((300, 400)) > 0.995).astype(np.uint8)
    for r in (1, 7, 24):
        fp = dtu.ellipse_footprint(2 * r + 1, 2 * r + 1)
        np.testing.assert_array_equal(dtu.dilate(mask, fp, cuda),
                                      dtu.dilate(mask, fp, "cpu"))


def test_lpips_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Random weights at 1/8 of VGG16's widths: the card's LPIPS within
    rel 1e-4 of the CPU's, with TF32 turned on by the caller."""
    from gs2d_torch.eval.lpips import LPIPS, TAPS, VGG_PLAN
    rng = np.random.default_rng(1)
    w, cin = {}, 3
    for i, (cout, _) in enumerate(VGG_PLAN):
        cout //= 8
        w[f"conv{i}_w"] = (rng.standard_normal((cout, cin, 3, 3))
                           * math.sqrt(2 / (9 * cin))).astype(np.float32)
        w[f"conv{i}_b"] = np.zeros(cout, np.float32)
        cin = cout
    for j, t in enumerate(TAPS):
        w[f"lin{j}"] = rng.random(VGG_PLAN[t][0] // 8).astype(np.float32)
    np.savez(tmp_path / "w.npz", **w)
    x = rng.random((3, 90, 160)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    ref = float(LPIPS(str(tmp_path / "w.npz"), device="cpu")(
        torch.from_numpy(x), torch.from_numpy(y)))
    card = LPIPS(str(tmp_path / "w.npz"), device=cuda)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = float(card(torch.from_numpy(x).to(cuda),
                         torch.from_numpy(y).to(cuda)))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert got == pytest.approx(ref, rel=1e-4)


def test_render_noise_channel_cuda_matches_cpu(cuda):
    """The IG2G edit render: per-Gaussian noise composited by K1 into the
    rend_noise channel on the card, against the CPU at 2e-4."""
    outs = []
    noise = torch.randn((300, 3), generator=torch.Generator().manual_seed(3))
    for dev in (cuda, torch.device("cpu")):
        cam, (m, s, q, o, c) = _scene(dev, n=300)
        state = GaussianState(GaussianParams(
            xyz=m, features_dc=((c - 0.5) / 0.28209479177387814)[:, None],
            features_rest=torch.zeros((300, 15, 3), device=dev),
            scaling=torch.log(s), rotation=q,
            opacity=torch.logit(o)[:, None]), active_sh_degree=3)
        outs.append(render(cam, state, torch.zeros(3, device=dev),
                           noise=noise.to(dev), device=dev))
    got, ref = outs[0]["rend_noise"].cpu(), outs[1]["rend_noise"]
    assert float(ref.min()) == 0.0 and float(ref.max()) == 1.0
    torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)


class _CpuDraws:
    """The editor's draws from a CPU generator, moved to the card, so the
    card and the CPU edit see the same numbers."""

    def __init__(self, device):
        from gs2d_torch.ig2g.ip2p import Draws
        self.draws, self.device = Draws(7, "cpu"), device

    def timestep(self, lo, hi):
        return self.draws.timestep(lo, hi)

    def normal(self, shape):
        return self.draws.normal(shape).to(self.device)

    def posterior(self, shape):
        return self.draws.posterior(shape).to(self.device)


def test_ig2g_edit_on_the_card_matches_the_cpu(cuda):
    """``edit_image`` with a TINY SD backend (fused-skip mode, FreeU) on
    the card against the CPU, the same seeded weights and draws: within
    1e-5 on the [0, 1] image."""
    from gs2d_torch.ig2g import ip2p, sdnet, vae
    from gs2d_torch.ig2g.sd_weights import carry_params
    g = torch.Generator().manual_seed(0)
    unet_p = sdnet.init_params(sdnet.unet_param_shapes(sdnet.TINY_UNET), g,
                               device="cpu")
    vae_p = sdnet.init_params(vae.vae_param_shapes(vae.TINY_VAE), g,
                              device="cpu")
    img, cond, noise = (torch.rand((1, 3, 40, 24), generator=g)
                        for _ in range(3))
    ctx = torch.randn((3, 5, 16), generator=g)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        be = ip2p.TorchSDBackend(
            unet=carry_params(sdnet.UNet2DCondition(sdnet.TINY_UNET,
                                                    device="meta"),
                              unet_p, "unet", dev),
            vae=carry_params(vae.AutoencoderKL(vae.TINY_VAE, device="meta"),
                             vae_p, "vae", dev),
            freeu=sdnet.FreeUParams(), device=dev)
        ed = ip2p.InstructPix2Pix(ip2p.IP2PParams(
            diffusion_steps=4, noise_type="encoded-normalized",
            freeu_mode="intermediate"), backend=be, device=dev)
        ed.draws = _CpuDraws(dev)
        outs.append(ed.edit_image(ctx.to(dev), img.to(dev), cond.to(dev),
                                  noise.to(dev)).cpu())
    assert outs[0].shape == (1, 3, 40, 24)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("height", [120, 100])
def test_band_kernels_match_plain_versions_at_odd_heights(cuda, height):
    """Every row band of 4 ranks (120 rows: 32/32/32/24; 100: 32/32/32/4)
    through ``rasterize_band`` on the card: K1 and K2 at the bands' rows
    against their plain versions on the same arguments, the stitched
    bands equal to the full view bit for bit, and the band gradients
    summed against the full view's at the gradient bar."""
    from gs2d_torch.ops.rasterize import api
    from gs2d_torch.parallel.data_parallel import rasterize_band
    from gs2d_torch.parallel.multihost import band_rows
    cam, (m, s, q, o, c) = _scene(cuda, W=160, H=height)
    pre0 = preprocess(m, s, q, o, cam.world_view, cam.full_proj, cam.campos,
                      cam.width, cam.height, colors=c)
    names = ("A", "B", "C", "opacity", "rgb")
    leaves = [getattr(pre0, f).detach().clone().requires_grad_()
              for f in names]
    pre = pre0._replace(**dict(zip(names, leaves)))
    g = torch.Generator(device=cuda).manual_seed(3)
    cot = torch.randn((15, height, 160), generator=g, device=cuda)
    full, _ = rasterize(pre, 160, height)
    g_full = torch.autograd.grad((full * cot).sum(), leaves)
    calls = {}
    real_f, real_b = api.rasterize_fwd, api.rasterize_bwd

    def keep(name, fn):
        def kept(*args):
            calls.setdefault(name, []).append(args)
            return fn(*args)
        return kept

    api.rasterize_fwd = keep("fwd", real_f)
    api.rasterize_bwd = keep("bwd", real_b)
    try:
        outs, g_sum = [], [torch.zeros_like(x) for x in leaves]
        for y0, y1 in band_rows(height, 4):
            out, _ = rasterize_band(pre, 160, height, y0, y1)
            grads = torch.autograd.grad((out * cot[:, y0:y1]).sum(), leaves)
            outs.append(out.detach())
            g_sum = [a + b for a, b in zip(g_sum, grads)]
    finally:
        api.rasterize_fwd, api.rasterize_bwd = real_f, real_b
    assert len(calls["fwd"]) == len(calls["bwd"]) == len(outs)
    for fargs, bargs in zip(calls["fwd"], calls["bwd"]):
        out, med, nc = kernel_fwd.rasterize_fwd(*fargs)
        rout, rmed, _ = kernel_fwd.rasterize_fwd_reference(*fargs)
        torch.testing.assert_close(out, rout, rtol=TOL, atol=TOL)
        assert (med == rmed).float().mean() >= 0.999
        d = kernel_bwd.rasterize_bwd(*bargs)
        ref = kernel_bwd.rasterize_bwd_reference(*bargs)
        scale = ref.abs().amax(dim=0).clamp(min=1e-6)
        torch.testing.assert_close(d / scale, ref / scale, rtol=1e-3,
                                   atol=5e-4)
    assert torch.equal(torch.cat(outs, dim=1), full.detach())
    for name, a, b in zip(names, g_sum, g_full):
        scale = b.abs().max().clamp(min=1e-6)
        torch.testing.assert_close(a / scale, b / scale, rtol=1e-3,
                                   atol=5e-4, msg=name)


def test_viewer_frame_on_the_card(cuda):
    """One viewer frame on the card: a client's message through
    ``NetworkGUI`` (a socket pair), the render at its resolution and each
    of the six modes' bytes, the RGB frame equal to the same camera's
    render."""
    import json
    import socket
    import struct

    from gs2d_torch.render.network_gui import (NetworkGUI, frame_bytes,
                                               render_net_image)
    cam, (m, s, q, o, c) = _scene(cuda, W=200, H=120)
    state = GaussianState(
        params=GaussianParams(
            xyz=m, features_dc=((c - 0.5) / 0.28209479177387814)[:, None],
            features_rest=torch.zeros((m.shape[0], 0, 3), device=cuda),
            scaling=torch.log(s), rotation=q,
            opacity=torch.logit(o)[:, None]),
        active_sh_degree=0)
    wv = cam.world_view.cpu().numpy().copy()
    fp = cam.full_proj.cpu().numpy().copy()
    wv[:, 1:3] = -wv[:, 1:3]
    fp[:, 1] = -fp[:, 1]
    items = ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]
    a, b = socket.socketpair()
    gui = NetworkGUI(device=cuda)
    gui.listener.close()
    gui.conn = b
    try:
        for mode in range(len(items)):
            msg = json.dumps({
                "resolution_x": 200, "resolution_y": 120, "train": False,
                "fov_y": cam.fovy, "fov_x": cam.fovx, "z_near": 0.01,
                "z_far": 100.0, "keep_alive": True, "scaling_modifier": 1.0,
                "view_matrix": wv.flatten().tolist(),
                "view_projection_matrix": fp.flatten().tolist(),
                "render_mode": mode}).encode()
            a.sendall(struct.pack("I", len(msg)) + msg)
            got, _, _, scaling, mode_got = gui.receive()
            assert got.device.type == "cuda" and mode_got == mode
            pkg = render(got, state, torch.zeros(3, device=cuda),
                         max_sh_degree=0, scaling_modifier=scaling,
                         device=cuda)
            frame = frame_bytes(render_net_image(pkg, items, mode))
            assert len(frame) == 200 * 120 * 3
            if mode == 0:
                ref = render(cam, state, torch.zeros(3, device=cuda),
                             max_sh_degree=0, device=cuda)
                diff = np.abs(np.frombuffer(frame, np.uint8).astype(int)
                              - np.frombuffer(frame_bytes(ref["render"]),
                                              np.uint8))
                assert diff.max() <= 1
    finally:
        a.close()
        b.close()


def test_clip_metrics_on_the_card_match_the_cpu(cuda, tmp_path):
    """A seeded TINY CLIP snapshot (both pooling rules): pixel values
    equal, image and text features within rtol 1e-4 / atol 1e-5 of the
    CPU's (FP32 matrix products), the CLIP score and the directional
    similarity within 1e-4."""
    from gs2d_torch.ig2g import clip_model
    from gs2d_torch.ig2g.metrics import ClipMetrics
    from gs2d_torch.ig2g.tokenizer import write_synthetic_tokenizer
    rng = np.random.default_rng(0)
    orig = rng.random((3, 90, 160)).astype(np.float32)
    edit = np.clip(orig[:, ::-1] * 1.1, 0, 1).copy()
    # the synthetic tokenizer's end-of-text id is its last
    eot = write_synthetic_tokenizer(str(tmp_path / "probe"), ["snow"]) - 1
    for eos in (2, eot):
        root = str(tmp_path / f"eos{eos}")
        cfg = clip_model.CLIPConfig(clip_model.TINY.text,
                                    clip_model.TINY.vision,
                                    clip_model.TINY.projection, eos)
        clip_model.write_random_snapshot(
            root, cfg, torch.Generator().manual_seed(eos), ["snow"],
            device="cpu", dtype=torch.float32)
        cpu, card = ClipMetrics(root, device="cpu"), ClipMetrics(root)
        px_cpu, px_card = cpu.model.pixels(orig), card.model.pixels(orig)
        assert torch.equal(px_card.cpu(), px_cpu)
        with torch.no_grad():
            for a, b in ((cpu.model.model.get_image_features(px_cpu),
                          card.model.model.get_image_features(px_card)),
                         (cpu.model.model.get_text_features(
                             cpu.model.ids("snow")),
                          card.model.model.get_text_features(
                              card.model.ids("snow")))):
                torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-5)
        assert abs(card.clip_score(orig, "snow")
                   - cpu.clip_score(orig, "snow")) <= 1e-4
        assert abs(card.directional_similarity(orig, edit, "a", "snow")
                   - cpu.directional_similarity(orig, edit, "a", "snow")) \
            <= 1e-4


@pytest.mark.parametrize("channels", [3, 1])
def test_jpeg_encoder_on_the_card_writes_the_cpus_bytes(cuda, tmp_path,
                                                        channels):
    """The encoder's pixel stages on the card give the file the CPU's
    give, byte for byte, at 1080p and at a size off the block grid."""
    from gs2d_torch.scene.jpeg import encode_jpeg
    rng = np.random.default_rng(channels)
    for h, w in ((1080, 1920), (37, 53)):
        shape = (h, w, 3) if channels == 3 else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        encode_jpeg(str(tmp_path / "cpu.jpg"), img)
        encode_jpeg(str(tmp_path / "card.jpg"),
                    torch.as_tensor(img, device=cuda))
        assert (tmp_path / "card.jpg").read_bytes() == \
            (tmp_path / "cpu.jpg").read_bytes()


def test_resize_on_the_card_matches_the_cpu(cuda):
    """PIL's bicubic (premultiplied for RGBA) on the card, bit for bit."""
    from gs2d_torch.scene.images import resize
    rng = np.random.default_rng(5)
    for shape in ((1080, 1920, 3), (97, 131, 4), (50, 70)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for w, h in ((shape[1] // 2, shape[0] // 2),
                     (shape[1] // 8, shape[0] // 8)):
            np.testing.assert_array_equal(resize(img, w, h, device=cuda),
                                          resize(img, w, h))


def test_bench_scale_on_the_card(cuda):
    """The scale benchmark at a small N on the card: every stage's time
    finite and positive, the kernels launched as its stages say, the
    allocator's peak recorded."""
    from gs2d_torch.cli import bench, bench_scale
    iters = 2
    rec = bench_scale.bench_one(20_000, 320, 192, iters, cuda)
    for k in ("t_preprocess_ms", "t_binning_ms", "t_gather_ms",
              "t_fwd_kernel_ms", "t_bwd_kernel_ms", "t_bwd_glue_ms",
              "t_e2e_fwd_ms", "t_e2e_fwd_bwd_ms", "rays_per_s_fwd_bwd"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert 0 < rec["num_pairs"] <= rec["num_pairs_uncull"]
    calls = bench.WARMUP + iters
    # K1: its stage, the outputs K2's stage reads, e2e fwd, e2e fwd+bwd
    assert rec["kernel_launches"] == {"rasterize_fwd": 3 * calls + 1,
                                      "rasterize_bwd": 2 * calls,
                                      "gather_rows": calls}
    assert rec["peak_hbm_gb"] > 0


def test_sharded_checkpoint_in_an_nccl_group(cuda, tmp_path):
    """save_checkpoint_sharded / load_checkpoint_sharded in an NCCL group
    of one rank on a (1, 1) grid: the round trip bit for bit on the card,
    and the same files loaded onto the CPU without a group."""
    import socket

    import torch.distributed as dist

    from gs2d_torch.models.io import (load_checkpoint_sharded,
                                      save_checkpoint_sharded)
    from gs2d_torch.parallel import gaussian_parallel as gp
    from gs2d_torch.parallel.multihost import initialize_distributed
    _, state = _state(cuda, n=1000)
    opt = init_adam(state.params)
    for tree in (opt.mu, opt.nu):
        for f in FIELDS:
            getattr(tree, f).normal_()
    state.denom.uniform_()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        grid = gp.make_grid(1, 1)
        path = str(tmp_path / "ck")
        save_checkpoint_sharded(path, state, opt, 42, 1.5, grid=grid)
        back = load_checkpoint_sharded(path, grid=grid, device=cuda)
    finally:
        dist.destroy_process_group()
    host = load_checkpoint_sharded(path, device="cpu")
    for got, dev in ((back, cuda), (host, torch.device("cpu"))):
        st, op, it, slr = got
        assert (it, slr, op.step, st.active_sh_degree) == (42, 1.5, 0, 3)
        for f in FIELDS:
            for a, b in ((st.params, state.params), (op.mu, opt.mu),
                         (op.nu, opt.nu)):
                assert getattr(a, f).device.type == dev.type
                assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
        assert torch.equal(st.denom.cpu(), state.denom.cpu())


# --- the preprocess kernels (csrc/preprocess_fwd.cu, preprocess_bwd.cu) ---

_PRE_FIELDS = {"A": slice(0, 3), "B": slice(3, 6), "C": slice(6, 9),
               "c2": slice(9, 12), "center2d": slice(12, 14),
               "opacity": slice(14, 15), "rgb": slice(15, 18),
               "normal": slice(18, 21), "noise": slice(21, 24)}
_PRE_LEAVES = ("xyz", "scaling", "rotation", "opacity", "features_dc",
               "features_rest", "colors", "noise", "screen_offsets")


def _pre_inputs(dev, mode, n=4000, seed=0):
    """Raw parameters of a small cloud and a camera for one mode:
    (max degree or None for colours, active degree, offsets and noise,
    scale modifier, spread, rows forced non-finite)."""
    deg, active, extra, smod, spread, bad = {
        "colors": (None, 0, True, 1.0, 1.0, ()),
        "sh0": (0, 0, False, 1.0, 1.0, ()),
        "sh1": (1, 1, False, 1.0, 1.0, ()),
        "sh2": (2, 2, True, 1.0, 1.0, ()),
        "sh3": (3, 3, True, 1.0, 1.0, ()),
        "sh4": (4, 4, False, 1.0, 1.0, ()),
        "sh3_active1": (3, 1, False, 1.0, 1.0, ()),
        "sh3_modifier": (3, 3, True, 0.7, 1.0, ()),
        "sh3_wide": (3, 2, True, 1.0, 6.0, ()),
        "sh3_nonfinite": (3, 3, True, 1.0, 1.0, (3, 17)),
    }[mode]
    rng = np.random.default_rng(seed)
    W, H = 160, 96
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cam = make_camera(np.eye(3), np.array([0, 0, 4.0]), fovx, fovy, W, H,
                      device=dev)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    p = {"xyz": t(rng.uniform(-spread, spread, (n, 3))),
         "scaling": t(np.log(rng.uniform(0.02, 0.25, (n, 2)))),
         "rotation": t(rng.normal(size=(n, 4))),
         "opacity": t(rng.normal(size=(n, 1)) * 2.0)}
    if deg is None:
        p["colors"] = t(rng.random((n, 3)))
    else:
        p["features_dc"] = t(rng.normal(size=(n, 1, 3)))
        p["features_rest"] = t(rng.normal(size=(n, (deg + 1) ** 2 - 1, 3))
                               * 0.3)
    if extra:
        p["noise"] = t(rng.normal(size=(n, 3)))
        p["screen_offsets"] = t(rng.normal(size=(n, 2)))
    for k, row in enumerate(bad):
        p["noise"][row, 1] = math.inf
        if k:
            p["features_rest"][row, 2, 0] = math.inf
    return p, cam, {"sh_degree": active, "scale_modifier": smod}


def _pre_args(p, cam):
    return ([p.get(f) for f in _PRE_LEAVES]
            + [cam.world_view, cam.full_proj, cam.campos, cam.width,
               cam.height])


def _pre_compare(p, cam, kw, cot_seed=1):
    """The kernels against their plain versions, both on the card:
    visible and radii identical; every record field, depth, extent and
    rho2max within 1e-6 of the field's largest magnitude; every gradient
    within 1e-5 of the leaf's largest magnitude. Returns the largest
    errors."""
    from gs2d_torch.ops.rasterize import preprocess as pp
    args = _pre_args(p, cam)
    got = pp.preprocess_fwd(*args, **kw)
    want = pp.preprocess_fwd_reference(*args, **kw)
    assert torch.equal(got[3], want[3]), "radii"
    assert torch.equal(got[4], want[4]), "visible"
    err = {}
    for name, sl in _PRE_FIELDS.items():
        a, b = got[0][:, sl], want[0][:, sl]
        err[name] = float((a - b).abs().max()
                          / b.abs().max().clamp(min=1e-30))
    for name, k in (("depth", 1), ("extent", 2), ("rho2max", 5)):
        a, b = got[k], want[k]
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a)), name
        err[name] = float((a[fin] - b[fin]).abs().max()
                          / b[fin].abs().max().clamp(min=1e-30))
    assert max(err.values()) <= 1e-6, err
    cot = torch.randn(got[0].shape, device=got[0].device,
                      generator=torch.Generator(got[0].device).manual_seed(
                          cot_seed))
    g_k = pp.preprocess_bwd(cot, *args, **kw)
    g_p = pp.preprocess_bwd_reference(cot, *args, **kw)
    gerr = {}
    for name, a, b in zip(_PRE_LEAVES, g_k, g_p):
        assert (a is None) == (b is None), name
        if a is None or not b.numel():
            continue
        assert torch.isfinite(a).all(), name
        gerr[name] = float((a - b).abs().max()
                           / b.abs().max().clamp(min=1e-30))
    assert max(gerr.values()) <= 1e-5, gerr
    return err, gerr


@pytest.mark.parametrize("mode", ["colors", "sh0", "sh1", "sh2", "sh3",
                                  "sh4", "sh3_active1", "sh3_modifier",
                                  "sh3_wide", "sh3_nonfinite"])
def test_preprocess_kernels_match_plain_versions(cuda, mode):
    from gs2d_torch.ops.rasterize import preprocess as pp
    p, cam, kw = _pre_inputs(cuda, mode)
    f0, b0 = pp.preprocess_fwd.launches, pp.preprocess_bwd.launches
    _pre_compare(p, cam, kw)
    assert pp.preprocess_fwd.launches == f0 + 1
    assert pp.preprocess_bwd.launches == b0 + 1
    if mode == "sh3_nonfinite":
        packed, *aux = pp.preprocess_fwd(*_pre_args(p, cam), **kw)
        assert (packed[[3, 17]] == 0).all() and not aux[3][[3, 17]].any()
        g = pp.preprocess_bwd(torch.ones_like(packed), *_pre_args(p, cam),
                              **kw)
        for x in g:
            if x is not None:
                assert (x[[3, 17]] == 0).all()


def test_preprocess_kernels_at_the_outdoor_scene(cuda):
    """3.0M surfels of the benchmark's outdoor scene, from its first test
    view: the kernels against their plain versions."""
    import json as _json
    from pathlib import Path
    from perfbench import scene as scenes
    root = Path(__file__).resolve().parents[1]
    cfg = _json.loads((root / "perfbench" / "configs"
                       / "m360-outdoor.json").read_text())
    p = scenes.make_params(cfg, 20261018, cuda)
    assert p["xyz"].shape[0] == 3_000_000
    rig = scenes.make_rig(cfg)
    v = rig.views[rig.test[0]]
    cam = make_camera(v.R, v.t, v.fovx, v.fovy, v.width, v.height,
                      device=cuda)
    p["screen_offsets"] = torch.zeros((3_000_000, 2), device=cuda)
    _pre_compare(p, cam, {"sh_degree": 3})


def test_render_and_step_go_through_the_preprocess_kernels(cuda):
    """One render launches the forward kernel once and counts
    ``preprocess.kernel`` once; one train step launches each kernel
    once; the render's preprocess makes no host sync."""
    from gs2d_torch.ops.rasterize import preprocess as pp
    from gs2d_torch.utils import trace
    cam, state = _state(cuda)
    gt = torch.rand((3, cam.height, cam.width), device=cuda)
    bg = torch.zeros(3, device=cuda)
    step = make_train_step(OptimizationParams(), device=cuda)
    ts = TrainState(gaussians=state, opt=init_adam(state.params))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for what in ("render", "step"):
        f0, b0 = pp.preprocess_fwd.launches, pp.preprocess_bwd.launches
        trace.reset()
        with torch.profiler.profile(activities=acts):
            if what == "render":
                with torch.no_grad():
                    render(cam, state, bg, device=cuda)
            else:
                step(ts, cam, gt, 8000, bg)
        torch.cuda.synchronize()
        s = trace.summary()
        assert s["counts"]["preprocess.kernel"] == 1, what
        assert pp.preprocess_fwd.launches == f0 + 1, what
        assert pp.preprocess_bwd.launches == b0 + (what == "step"), what
        assert "sync" not in s["spans"]["render.prepare"]["counts"], what
