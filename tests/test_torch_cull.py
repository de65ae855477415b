"""The binning's interval cull on the port (``bin_gaussians(...,
cull_abc=, rho2max=)``, gs2d_torch/ops/rasterize/binning.py) against the
JAX package's.

The four properties of tests/test_cull.py, on the port:

  * images with the cull equal those without it, at 2e-4
    (tests/test_rasterize_fwd.py:79-80), from fewer pairs;
  * every dropped pair's largest alpha over its tile's pixels, by the
    kernels' per-pixel formula in float32, is below ALPHA_CUTOFF;
  * every pair that the JAX package's exact per-tile oracle
    (``binning._pair_contributes``) keeps is in the port's lists;
  * the port's culled lists against the JAX culled lists: on scenes whose
    rectangles span at most 16 tile rows (the JAX strips are then single
    rows) each port list is the JAX list with a few pairs added, in order
    (the port adds rounding bounds of the discriminant that the JAX cull
    lacks, and without which it drops pairs of splats seen nearly
    edge-on); on taller rectangles the port's lists are a subset of the
    JAX lists (its strips are wider) that holds the exact keep set.

Scenes: the seeded scenes of tests/test_torch_binning.py, and three made
to reach the guards: non-finite coefficients and near-edge-on splats (the
``cond`` fallback to the full rectangle row), and every opacity at 0.0045,
just above the cutoff. Both packages bin the same preprocess fields (the
JAX package's), so the lists compare the binning alone.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_torch.ops.rasterize.api import rasterize, reduce_slot_grads
from gs2d_torch.ops.rasterize.binning import _conic_constants
from gs2d_torch.ops.rasterize.binning import bin_gaussians as t_bin
from gs2d_torch.ops.rasterize.common import (ALPHA_CUTOFF, DENTRY_F,
                                             FILTER_INV_SQUARE, TILE_H,
                                             TILE_W, cdiv)
from gs2d_torch.ops.rasterize.preprocess import PreprocessOut
from gs2d_tpu.ops.rasterize.binning import _pair_contributes
from gs2d_tpu.ops.rasterize.binning import bin_gaussians as j_bin
from gs2d_tpu.ops.rasterize.preprocess import preprocess as j_preprocess

from .test_torch_binning import _scene
from .test_torch_common import one_torch_thread, tile_lists, to_t  # noqa: F401
from .utils import lookat_camera, random_cloud

SEEDED = {"seed0": (0, 400, 128, 96), "seed1": (1, 400, 128, 96),
          "seed2": (2, 250, 200, 72)}
SCENES = list(SEEDED) + ["nonfinite", "edge_on", "opacity_0.0045"]
POISONED = (3, 17, 40)      # the non-finite scene's poisoned Gaussians
NEAR = 12                   # the edge-on scene's splats near the camera


def _jax_pre(cloud, w, h, opacity=None):
    means, scales, quats, opac, rgb, _ = cloud
    if opacity is not None:
        opac = np.full_like(opac, opacity)
    cam = lookat_camera(w, h)
    return j_preprocess(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(opac), cam.world_view, cam.full_proj, cam.campos, w, h,
        colors=jnp.asarray(rgb))


@functools.cache
def _fields(name):
    """(JAX preprocess output, width, height) of a named scene."""
    if name in SEEDED:
        seed, n, w, h = SEEDED[name]
        return _scene(n, seed, w, h)[0], w, h
    w, h = 128, 96
    if name == "nonfinite":
        jp = _scene(300, 3, w, h)[0]
        vis = np.flatnonzero(np.asarray(jp.visible))
        g = vis[list(POISONED)]
        A = jp.A.at[g[0], 0].set(jnp.inf).at[g[1], 2].set(-jnp.inf)
        B = jp.B.at[g[2], 1].set(jnp.nan)
        return jp._replace(A=A, B=B), w, h
    if name == "edge_on":
        # normals within 0.01 degree of perpendicular to each splat's own
        # view ray (the camera sits at z = -4): near-edge-on slivers, whose
        # discriminant is convex (alf >= 0); and 12 large splats just in
        # front of the camera, whose support reaches past its plane: quu,
        # the chord's denominator, is no longer positive and cond falls
        # back to the full rectangle row. 60 of the slivers are exactly
        # edge-on: alf is 0 but for rounding, which float64 conic
        # constants alone do not cover (binning._conic_constants)
        cloud = list(random_cloud(300, 5, scale_lo=0.05, scale_hi=0.5))
        rng = np.random.default_rng(5)
        view = cloud[0] - np.float32([0.0, 0.0, -4.0])
        view /= np.linalg.norm(view, axis=1, keepdims=True)
        nrm = np.cross(view, rng.normal(size=(300, 3)))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        tilt = rng.uniform(-2e-4, 2e-4, (300, 1))
        tilt[NEAR:NEAR + 60] = 0.0
        nrm = np.cos(tilt) * nrm + np.sin(tilt) * view
        q = np.stack([1 + nrm[:, 2], -nrm[:, 1], nrm[:, 0], 0 * tilt[:, 0]],
                     -1)
        q[:NEAR] = cloud[2][:NEAR]
        cloud[2] = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
            np.float32)
        cloud[0][:NEAR] = np.stack(
            [rng.uniform(-0.3, 0.3, NEAR), rng.uniform(-0.2, 0.2, NEAR),
             rng.uniform(-3.6, -3.0, NEAR)], -1)
        cloud[1][:NEAR] = rng.uniform(0.3, 1.0, (NEAR, 2))
        return _jax_pre(cloud, w, h), w, h
    assert name == "opacity_0.0045"
    return _jax_pre(random_cloud(300, 6, scale_lo=0.05, scale_hi=0.5), w, h,
                    opacity=0.0045), w, h


def _bins(jp, w, h, capacity=1 << 15):
    """(JAX culled, port culled, port un-culled) binning of the same
    fields."""
    jb = j_bin(jp.center2d, jp.extent, jp.depth, jp.visible, w, h,
               capacity, 128, cull_abc=(jp.A, jp.B, jp.C),
               rho2max=jp.rho2max)
    assert not bool(jb.overflow)
    args = [to_t(x) for x in (jp.center2d, jp.extent, jp.depth, jp.visible)]
    tb = t_bin(*args, w, h, cull_abc=(to_t(jp.A), to_t(jp.B), to_t(jp.C)),
               rho2max=to_t(jp.rho2max))
    t0 = t_bin(*args, w, h)
    return jb, tb, t0


def _lists(b):
    return tile_lists(b.gid, b.tile_start, b.tile_count)


@functools.cache
def _case(name):
    """A named scene's fields, its three binnings and the exact oracle's
    keep set over its un-culled pairs, computed once per module."""
    jp, w, h = _fields(name)
    jb, tb, t0 = _bins(jp, w, h)
    return jp, w, h, jb, tb, t0, _exact_keep(jp, _lists(t0), w, h)


def _exact_keep(jp, lists0, w, h):
    """The JAX oracle's verdict on every (gaussian, tile) pair of the
    un-culled lists → set of kept (g, t)."""
    ntx = cdiv(w, TILE_W)
    pairs = [(g, t) for t, gs in enumerate(lists0) for g in gs]
    gi = jnp.asarray([g for g, _ in pairs], jnp.int32)
    grec = jnp.concatenate(
        [jnp.zeros((jp.A.shape[0], 5), jnp.float32), jp.A, jp.B, jp.C,
         jp.center2d, jp.rho2max[:, None]], axis=1)
    t = np.array([t for _, t in pairs])
    keep = np.asarray(_pair_contributes(
        lambda c: grec[gi, c], jnp.asarray(t % ntx, jnp.int32),
        jnp.asarray(t // ntx, jnp.int32), w, h))
    return {p for p, k in zip(pairs, keep) if k}


def _branches(jp):
    """Among visible Gaussians: (those whose rows fall back to the full
    rectangle because the cull's ``cond`` fails, those whose discriminant
    is convex, alf >= 0)."""
    k = _conic_constants(to_t(jp.A), to_t(jp.B), to_t(jp.C),
                         to_t(jp.center2d), to_t(jp.rho2max))
    vis = to_t(jp.visible)
    return int(((k[:, 10] == 0) & vis).sum()), int(((k[:, 0] >= 0) & vis)
                                                    .sum())


@pytest.mark.parametrize("name", SCENES)
def test_culled_lists_against_jax(name):
    """The tile grid has at most 16 rows, so every JAX strip is a single
    row. The port's intervals are the JAX intervals plus the rounding
    bounds of the discriminant, so each port list is the JAX list with
    pairs added, in the same order. On the seeded scenes the bounds add
    under 0.5% of the pairs; on the edge-on scene they add back every
    pair that the exact oracle keeps and the JAX cull drops (it drops
    some: float32 cancellation in alf). The guard scenes must reach the
    fallback and the convex branch."""
    jp, w, h = _fields(name)
    assert cdiv(h, TILE_H) <= 16
    if name == "nonfinite":
        assert _branches(jp)[0] >= len(POISONED)
    if name == "edge_on":
        fallback, convex = _branches(jp)
        assert fallback >= NEAR // 2 and convex >= 50
    jp, w, h, jb, tb, t0, keep = _case(name)
    jl, tl = _lists(jb), _lists(tb)
    for a, b in zip(tl, jl):
        assert [g for g in a if g in set(b)] == b and set(b) <= set(a)
    added = {(g, t) for t, (a, b) in enumerate(zip(tl, jl))
             for g in set(a) - set(b)}
    assert int(jb.num_pairs) + len(added) == tb.num_pairs < t0.num_pairs
    assert int(tb.counts.sum()) == tb.num_pairs
    assert tb.perm.shape == (tb.num_pairs,)
    if name in SEEDED:
        assert len(added) <= 0.005 * tb.num_pairs
    if name == "edge_on":
        jax_set = {(g, t) for t, gs in enumerate(jl) for g in gs}
        jax_misses = keep - jax_set
        assert jax_misses and jax_misses <= added


@pytest.mark.parametrize("name", SCENES)
def test_cull_keeps_the_exact_keep_set(name):
    jp, w, h, _, tb, t0, keep = _case(name)
    culled = {(g, t) for t, gs in enumerate(_lists(tb)) for g in gs}
    assert len(keep) > 100
    missing = keep - culled
    assert not missing, f"exact-keep pairs missing: {sorted(missing)[:5]}"


@pytest.mark.parametrize("name", SCENES)
def test_dropped_pairs_never_composite(name):
    """A dropped pair's alpha, by the kernels' per-pixel formula in
    float32, is below the cutoff on every pixel of its tile; Gaussians
    with non-finite coefficients keep their whole rectangle."""
    jp, w, h, _, tb, t0, _ = _case(name)
    ntx = cdiv(w, TILE_W)
    A, B, C = (np.asarray(x, np.float32) for x in (jp.A, jp.B, jp.C))
    c2d = np.asarray(jp.center2d)
    op = np.asarray(jp.opacity)
    bad = ~np.isfinite(np.concatenate([A, B, C], 1)).all(1)
    n_dropped = 0
    for t, (full, kept) in enumerate(zip(_lists(t0), _lists(tb))):
        assert set(kept) <= set(full), "the cull added a pair"
        dropped = sorted(set(full) - set(kept))
        if not dropped:
            continue
        assert not bad[dropped].any(), "a non-finite Gaussian was culled"
        n_dropped += len(dropped)
        ty_, tx_ = divmod(t, ntx)
        xs = np.arange(tx_ * TILE_W, (tx_ + 1) * TILE_W, dtype=np.float32)
        ys = np.arange(ty_ * TILE_H, (ty_ + 1) * TILE_H, dtype=np.float32)
        X, Y = np.meshgrid(np.minimum(xs, w - 1.0), np.minimum(ys, h - 1.0))
        g = np.array(dropped)[:, None, None]
        p0 = A[g, 0] + B[g, 0] * X + C[g, 0] * Y
        p1 = A[g, 1] + B[g, 1] * X + C[g, 1] * Y
        p2 = A[g, 2] + B[g, 2] * X + C[g, 2] * Y
        p2ok = np.abs(p2) > 1e-12
        rp2 = np.float32(1.0) / np.where(p2ok, p2, np.float32(1.0))
        rho3d = (p0 * rp2) ** 2 + (p1 * rp2) ** 2
        rho2d = np.float32(FILTER_INV_SQUARE) * (
            (X - c2d[g, 0]) ** 2 + (Y - c2d[g, 1]) ** 2)
        alpha = np.where(p2ok, op[g] * np.exp(
            np.float32(-0.5) * np.minimum(rho3d, rho2d)), 0.0)
        assert alpha.max() < ALPHA_CUTOFF, (t, alpha.max())
    assert n_dropped > 0
    if name == "nonfinite":
        vis = np.flatnonzero(np.asarray(jp.visible))
        for g in vis[list(POISONED)]:
            tiles = [[t for t, gs in enumerate(_lists(b)) if g in gs]
                     for b in (t0, tb)]
            assert tiles[0] == tiles[1] != []


@pytest.mark.parametrize("name", ["seed0", "nonfinite", "edge_on",
                                  "opacity_0.0045"])
def test_cull_image_equal_with_fewer_pairs(name):
    """The port's image (the plain K1 on the CPU) with and without the
    cull, at 2e-4, and the largest difference is reported."""
    jp, w, h = _fields(name)
    pre = PreprocessOut(*(to_t(x) for x in jp))
    img1, aux1 = rasterize(pre, w, h)
    img0, aux0 = rasterize(pre, w, h, cull=False)
    assert 0 < aux1["num_pairs"] < aux0["num_pairs"]
    assert float(img0[4].max()) > 0
    diff = float((img1 - img0).abs().max())
    assert torch.allclose(img1, img0, rtol=2e-4, atol=2e-4), diff


def test_reduction_on_culled_lists():
    """reduce_slot_grads on culled bins (perm, counts) against a plain
    index_add_ of the slot rows by Gaussian id."""
    jp, w, h, _, tb, _, _ = _case("seed1")
    n = jp.A.shape[0]
    rows = torch.as_tensor(np.random.default_rng(3).normal(
        size=(tb.num_pairs, DENTRY_F)).astype(np.float32))
    got = reduce_slot_grads(rows, tb, n)
    ref = torch.zeros((n, DENTRY_F)).index_add_(0, tb.gid.long(), rows)
    assert (got[:, 12:14] == 0).all()
    torch.testing.assert_close(torch.cat([got[:, :12], got[:, 14:]], 1),
                               ref, rtol=1e-5, atol=1e-5)


def test_tall_rectangles_within_jax_strips():
    """Splats whose rectangles span more than 16 tile rows: the JAX
    package widens them into strips of several rows, the port keeps one
    interval per row, so its lists are a subset of the JAX lists, in the
    same order, and still hold the exact keep set."""
    w, h = 256, 1024
    means, scales, quats, opac, rgb, noise = random_cloud(
        60, 8, spread=0.8, scale_lo=0.8, scale_hi=1.6)
    jp = _jax_pre((means, scales, quats, opac, rgb, noise), w, h)
    rows = np.asarray(jp.extent)[np.asarray(jp.visible), 1] * 2 / TILE_H
    assert rows.max() > 16
    jb, tb, t0 = _bins(jp, w, h, capacity=1 << 17)
    jl, tl = _lists(jb), _lists(tb)
    for a, b in zip(tl, jl):
        assert a == [g for g in b if g in set(a)] and set(a) <= set(b)
    assert tb.num_pairs < int(jb.num_pairs)
    culled = {(g, t) for t, gs in enumerate(tl) for g in gs}
    assert not _exact_keep(jp, _lists(t0), w, h) - culled
