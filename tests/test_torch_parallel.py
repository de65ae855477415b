"""The port's pixel-sharded render and its data-parallel and (gauss, data)
training steps (gs2d_torch/parallel/) against the JAX package's
(gs2d_tpu/parallel/, tests/test_parallel.py), on the same seeded inputs.

The port runs on 4 gloo ranks of spawned processes
(tests/test_torch_dist_common.py), the JAX package on a 4-device CPU
mesh (Pallas in interpret mode) in this process meanwhile. Bars, those of
tests/test_parallel.py: the lower half through ``rasterize_band`` against
the JAX full render at rtol 1e-4 / atol 1e-5; the sharded image's
channels other than the median at rtol 1e-3 / atol 1e-4, the median
differing on fewer than 1e-4 of the pixels; the steps' loss within 1e-4,
xyz at rtol 1e-3 / atol 1e-5, ``grad_accum`` at rtol 1e-3 / atol 1e-6 and
the (gauss, data) step's ``opt.mu.xyz`` at rtol 1e-3 / atol 1e-6; the
parameters bit-identical across the ranks. A height of 120 rows, which the
JAX sharded path cannot take (it asserts a multiple of n·16), is held
against the port's own single-device render at the same bar. The binning's
interval cull keeps, on band viewports up to y0 = 816, every pair the
exact oracle keeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gs2d_torch.ops.rasterize.api import rasterize as t_rasterize
from gs2d_torch.ops.rasterize.binning import bin_gaussians as t_bin
from gs2d_torch.parallel import data_parallel as t_dp
from gs2d_torch.parallel.multihost import band_rows
from gs2d_tpu.config import OptimizationParams
from gs2d_tpu.models.gaussians import init_from_pcd
from gs2d_tpu.ops.rasterize.api import RasterizeConfig
from gs2d_tpu.ops.rasterize.api import rasterize as j_rasterize
from gs2d_tpu.ops.rasterize.preprocess import preprocess as j_preprocess
from gs2d_tpu.parallel import data_parallel as j_dp
from gs2d_tpu.train.optim import init_adam
from gs2d_tpu.train.step import TrainState, make_train_step

from .test_torch_common import one_torch_thread, tile_lists, to_t  # noqa: F401
from .test_torch_cull import _edge_on_cloud, _exact_keep
from .test_torch_dist_common import (parallel_worker, preprocessed,
                                     start_ranks)
from .utils import lookat_camera, random_cloud

RANKS = 4
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def _jax_pre(cloud, w, h):
    means, scales, quats, opac, rgb, noise = (jnp.asarray(x) for x in cloud)
    cam = lookat_camera(width=w, height=h)
    return j_preprocess(means, scales, quats, opac, cam.world_view,
                        cam.full_proj, cam.campos, w, h, colors=rgb,
                        noise=noise)


def _cfg(w, h):
    return RasterizeConfig(width=w, height=h, pairs_capacity=1 << 13,
                           chunk=16, interpret=True)


def _jax_state():
    """tests/test_parallel.py's state, and its live rows as the port's
    ``state_from_numpy`` fields."""
    means, scales, quats, opac, rgb, _ = random_cloud(
        40, 3, spread=0.8, scale_lo=0.1, scale_hi=0.3)
    state = init_from_pcd(means, rgb, 64, init_scales=np.log(scales))
    fields = {f: np.asarray(getattr(state.params, f)) for f in FIELDS}
    fields.update(active=np.asarray(state.active),
                  active_sh_degree=int(state.active_sh_degree))
    return state, fields


@pytest.fixture(scope="module")
def runs():
    """The ranks' results and the JAX package's on the same inputs."""
    cloud = random_cloud(150, 0)
    odd = random_cloud(150, 7)
    state, fields = _jax_state()
    gt = np.random.default_rng(0).random((3, 128, 128)).astype(np.float32)
    ranks = start_ranks(parallel_worker, RANKS, cloud, odd, fields, gt)

    jax_out = {}
    devs = np.array(jax.devices()[:RANKS])
    pre = _jax_pre(cloud, 128, 128)
    jax_out["render"] = np.asarray(jax.jit(lambda p: j_dp.rasterize_sharded(
        p, _cfg(128, 128), Mesh(devs, ("data",))))(pre)[0])
    ts0 = TrainState(gaussians=state, opt=init_adam(state.params),
                     key=jax.random.PRNGKey(0))
    cfg, opt = _cfg(128, 128), OptimizationParams()
    for key, mesh in (("single", None),
                      ("dp", Mesh(devs, ("data",))),
                      ("gauss", Mesh(devs.reshape(2, 2), ("gauss", "data")))):
        ts, m = make_train_step(cfg, opt, mesh=mesh)(
            ts0, lookat_camera(128, 128), jnp.asarray(gt), jnp.int32(4000),
            jnp.zeros((3,), jnp.float32))
        act = np.asarray(ts.gaussians.active)
        jax_out[key] = {"loss": float(m["total_loss"]),
                        "xyz": np.asarray(ts.gaussians.params.xyz)[act],
                        "mu_xyz": np.asarray(ts.opt.mu.xyz)[act],
                        "grad_accum": np.asarray(ts.gaussians.grad_accum)[act]}
    return ranks.results(), jax_out, cloud, odd


def test_shift_viewport_and_band_match_jax():
    cloud = random_cloud(150, 0)
    jp = _jax_pre(cloud, 128, 64)
    tp = preprocessed(cloud, 128, 64)
    js, ts = j_dp.shift_viewport(jp, 32), t_dp.shift_viewport(tp, 32)
    for f in ("A", "center2d", "B", "C"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    full, _ = j_rasterize(jp, _cfg(128, 64))
    half, aux = t_dp.rasterize_band(tp, 128, 64, 32, 64)
    assert half.shape == (15, 32, 128) and aux["num_pairs"] > 0
    np.testing.assert_allclose(half.numpy(), np.asarray(full[:, 32:, :]),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        t_dp.rasterize_band(tp, 128, 64, 32, 80)


def test_band_rows_split():
    assert band_rows(1080, 4) == [(0, 272), (272, 544), (544, 816),
                                  (816, 1080)]
    assert band_rows(120, 4)[-1] == (96, 120)
    assert band_rows(1080, 1) == [(0, 1080)]
    with pytest.raises(ValueError):
        band_rows(40, 4)            # 16-row bands leave the last rank none


def _image_close(s, f):
    nonmed = [c for c in range(s.shape[0]) if c != 8]
    np.testing.assert_allclose(s[nonmed], f[nonmed], rtol=1e-3, atol=1e-4)
    assert (np.abs(s[8] - f[8]) > 1e-4).mean() < 1e-4


def test_sharded_render_matches_jax(runs):
    results, jax_out, cloud, _ = runs
    for r in results:
        np.testing.assert_array_equal(r["render"], results[0]["render"])
    _image_close(results[0]["render"], jax_out["render"])
    single, aux = t_rasterize(preprocessed(cloud, 128, 128), 128, 128)
    _image_close(results[0]["render"], single.numpy())
    pairs, most = results[0]["render_pairs"]
    assert most < pairs and pairs >= aux["num_pairs"]


def test_sharded_render_at_an_odd_height(runs):
    """120 rows over 4 ranks: bands of 32, 32, 32 and 24 rows."""
    results, _, _, odd = runs
    single, _ = t_rasterize(preprocessed(odd, 128, 120), 128, 120)
    assert results[0]["odd"].shape == (15, 120, 128)
    _image_close(results[0]["odd"], single.numpy())


def _step_close(got, ref, mu=False):
    assert abs(got["loss"] - ref["loss"]) < 1e-4
    np.testing.assert_allclose(got["xyz"], ref["xyz"], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got["grad_accum"], ref["grad_accum"],
                               rtol=1e-3, atol=1e-6)
    if mu:
        np.testing.assert_allclose(got["mu_xyz"], ref["mu_xyz"], rtol=1e-3,
                                   atol=1e-6)


def _same_on_every_rank(results, key):
    for r in results[1:]:
        for f, v in r[key].items():
            np.testing.assert_array_equal(v, results[0][key][f], err_msg=f)


def test_dp_train_step_matches_jax(runs):
    results, jax_out, _, _ = runs
    _same_on_every_rank(results, "dp")
    assert (results[0]["dp"]["denom"] > 0).any()
    for ref in ("single", "dp"):
        _step_close(results[0]["dp"], jax_out[ref])


def test_gauss_sharded_train_step_matches_jax(runs):
    results, jax_out, _, _ = runs
    assert [r["coords"] for r in results] == [(0, 0), (0, 1), (1, 0),
                                              (1, 1)]
    # each rank holds half of the 40 Gaussians (and their moments)
    assert [r["shard_rows"] for r in results] == [20, 20, 20, 20]
    _same_on_every_rank(results, "gauss")
    for ref in ("single", "gauss"):
        _step_close(results[0]["gauss"], jax_out[ref], mu=True)
    # the gauss-sharded step and the data-parallel step are one update
    for f in ("xyz", "mu_xyz", "grad_accum"):
        np.testing.assert_allclose(results[0]["gauss"][f],
                                   results[0]["dp"][f], rtol=1e-5,
                                   atol=1e-7, err_msg=f)


@pytest.mark.parametrize("scene", ["seed0", "edge_on"])
def test_cull_keeps_the_exact_keep_set_on_band_viewports(scene):
    """A 64x1080 view in the bands of 4 ranks (y0 up to 816): on each band
    viewport the port's culled lists hold every pair the JAX package's
    exact oracle keeps (tests/test_torch_cull.py, on the shifted A)."""
    w, h = 64, 1080
    cloud = (random_cloud(300, 0, scale_lo=0.05, scale_hi=0.5)
             if scene == "seed0" else _edge_on_cloud())
    jp = _jax_pre(cloud, w, h)
    kept = culled_pairs = pairs = 0
    for y0, y1 in band_rows(h, RANKS):
        jb = j_dp.shift_viewport(jp, y0)
        args = [to_t(x) for x in (jb.center2d, jb.extent, jb.depth,
                                  jb.visible)]
        culled = t_bin(*args, w, y1 - y0,
                       cull_abc=(to_t(jb.A), to_t(jb.B), to_t(jb.C)),
                       rho2max=to_t(jb.rho2max))
        every = t_bin(*args, w, y1 - y0)
        keep = _exact_keep(jb, tile_lists(every.gid, every.tile_start,
                                          every.tile_count), w, y1 - y0)
        lists = tile_lists(culled.gid, culled.tile_start, culled.tile_count)
        got = {(g, t) for t, gs in enumerate(lists) for g in gs}
        assert keep <= got, sorted(keep - got)[:5]
        kept += len(keep)
        culled_pairs += culled.num_pairs
        pairs += every.num_pairs
    assert kept > 100 and culled_pairs < pairs


def test_bands_are_the_whole_views_rows_bit_for_bit():
    """A 64x1080 view in the bands of 4 ranks (y0 up to 816), through the
    plain kernel versions: every band's 15 channels equal the whole
    view's rows exactly, the median included (binning, the cull and both
    kernels work in the image's own rows; folding y0·C into A, as the
    JAX package does, moved pixels of the 1080p view off the sharding
    bar), and the band gradients of a seeded linear loss sum to the whole
    view's at the gradient bar."""
    from .test_torch_kernel_bwd import assert_grad_close
    w, h = 64, 1080
    names = ("A", "B", "C", "c2", "opacity", "rgb")
    pre0 = preprocessed(random_cloud(300, 2, scale_lo=0.05, scale_hi=0.5),
                        w, h)
    leaves = [getattr(pre0, f).detach().clone().requires_grad_()
              for f in names]
    pre = pre0._replace(**dict(zip(names, leaves)))
    cot = torch.as_tensor(np.random.default_rng(3).normal(
        size=(15, h, w)).astype(np.float32))
    full, aux = t_rasterize(pre, w, h)
    g_full = torch.autograd.grad((full * cot).sum(), leaves)
    g_sum = [torch.zeros_like(x) for x in leaves]
    pairs = 0
    for y0, y1 in band_rows(h, RANKS):
        out, baux = t_dp.rasterize_band(pre, w, h, y0, y1)
        assert torch.equal(out, full[:, y0:y1]), (y0, y1)
        pairs += baux["num_pairs"]
        g = torch.autograd.grad((out * cot[:, y0:y1]).sum(), leaves)
        g_sum = [a + b for a, b in zip(g_sum, g)]
    assert pairs == aux["num_pairs"] > 1000
    for f, a, b in zip(names, g_sum, g_full):
        assert_grad_close(a.numpy(), b.numpy(), f)
    with pytest.raises(ValueError):
        t_dp.rasterize_band(pre, w, h, 8, 40)   # not on a tile row
