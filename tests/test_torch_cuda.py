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
