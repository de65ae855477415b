"""Port parity: gs2d_torch render() against gs2d_tpu render().

The JAX side renders a capacity-padded state (inactive rows included) at
128x64 with SH degree 3 through its Pallas kernel in interpret mode,
un-culled, and the port renders un-culled too so the pair counts are
comparable; one case runs both with the interval cull on (the default of
both), where the culled pair counts must agree as well. The port renders
the same model on the CPU, carried over by ``state_from_numpy`` or read
back from the JAX package's PLY by the port's ``load_ply``.

Bar: every key within rtol/atol 2e-4 (tests/test_rasterize_fwd.py:79-80);
radii, visibility and pair counts exactly equal; depth_median may differ
on at most 0.1% of pixels (the median flips at T = 0.5). surf_normal is
compared at 2e-4 where both depth maps are smooth (see
``_smooth_surf_mask``): the central-difference normal divides by depth
differences, so on a depth edge a 1e-6 change of depth turns the normal
by far more than the depth error.
"""

import numpy as np
import pytest
import torch

from gs2d_torch.models.gaussians import state_from_numpy
from gs2d_torch.models.io import load_ply as t_load_ply
from gs2d_torch.models.io import save_ply as t_save_ply
from gs2d_torch.ops.sh import rgb_to_sh
from gs2d_torch.render.renderer import render as t_render
from gs2d_tpu.models.gaussians import GaussianParams, GaussianState
from gs2d_tpu.models.io import load_ply as j_load_ply
from gs2d_tpu.models.io import save_ply as j_save_ply
from gs2d_tpu.ops.rasterize.api import RasterizeConfig
from gs2d_tpu.render.renderer import render as j_render

from .test_torch_common import port_camera, to_t
from .utils import lookat_camera, random_cloud

W, H = 128, 64
TOL = 2e-4
KEYS = ("render", "rend_alpha", "rend_normal", "rend_dist", "surf_depth",
        "rend_noise", "depth_expected")


def _jax_state(n=120, cap=128, seed=21, sh_degree=3):
    import jax.numpy as jnp
    means, scales, quats, opac, rgb, noise = random_cloud(n, seed)
    rng = np.random.default_rng(seed)
    K = (sh_degree + 1) ** 2

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    fields = dict(
        xyz=pad(means), features_dc=pad(rgb_to_sh(rgb)[:, None, :]),
        features_rest=pad((rng.normal(size=(n, K - 1, 3)) * 0.1)
                          .astype(np.float32)),
        scaling=pad(np.log(scales)), rotation=pad(quats, 1.0),
        opacity=pad(np.log(opac / (1 - opac))[:, None]))
    active = np.arange(cap) < n
    active[3] = False                      # a hole inside the live range
    state = GaussianState(
        params=GaussianParams(**{k: jnp.asarray(v) for k, v in
                                 fields.items()}),
        active=jnp.asarray(active), active_sh_degree=jnp.int32(sh_degree),
        max_radii2d=jnp.zeros(cap), grad_accum=jnp.zeros(cap),
        denom=jnp.zeros(cap))
    return state, fields, active, pad(noise)


def _smooth_surf_mask(a, b):
    """Pixels whose 3x3 neighbourhood has no depth edge in either map."""
    d = np.stack([a, b])                       # (2, H, W)
    pad = np.pad(d, ((0, 0), (1, 1), (1, 1)), mode="edge")
    win = np.stack([pad[:, i:i + H, j:j + W] for i in range(3)
                    for j in range(3)])
    spread = win.max(0) - win.min(0)           # (2, H, W)
    return (spread < 0.05 * np.maximum(np.abs(d), 1e-3)).all(0) & (d > 0).all(0)


def _compare(j_out, t_out, active):
    for k in KEYS:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    jm, tm = np.asarray(j_out["depth_median"]), t_out["depth_median"].numpy()
    flips = ~np.isclose(tm, jm, rtol=TOL, atol=TOL)
    assert flips.mean() <= 1e-3, flips.mean()
    mask = _smooth_surf_mask(np.asarray(j_out["surf_depth"])[0],
                             t_out["surf_depth"].numpy()[0])
    assert mask.mean() > 0.2
    np.testing.assert_allclose(t_out["surf_normal"].numpy()[:, mask],
                               np.asarray(j_out["surf_normal"])[:, mask],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(t_out["radii"].numpy(),
                                  np.asarray(j_out["radii"])[active])
    np.testing.assert_array_equal(
        t_out["visibility_filter"].numpy(),
        np.asarray(j_out["visibility_filter"])[active])
    assert t_out["num_pairs"] == int(j_out["num_pairs"]) > 0


def _jax_render(cull):
    import jax.numpy as jnp
    state, fields, active, noise = _jax_state()
    cfg = RasterizeConfig(width=W, height=H, pairs_capacity=1 << 14,
                          chunk=16, interpret=True, cull=cull)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    out = j_render(lookat_camera(W, H), state, cfg, jnp.asarray(bg),
                   max_sh_degree=3, noise=jnp.asarray(noise))
    return state, fields, active, noise, bg, out


@pytest.fixture(scope="module")
def jax_render():
    return _jax_render(cull=False)


def test_render_state_from_numpy(jax_render):
    state, fields, active, noise, bg, j_out = jax_render
    t_state = state_from_numpy(**fields, active=active, active_sh_degree=3,
                               device="cpu")
    assert t_state.params.xyz.shape[0] == active.sum()
    t_out = t_render(port_camera(W, H), t_state, to_t(bg), max_sh_degree=3,
                     noise=to_t(noise[active]), cull=False, device="cpu")
    _compare(j_out, t_out, active)


def test_render_culled_matches_jax_culled():
    """Both packages with the interval cull on, their default: the same
    bar, and the culled pair counts equal and below the un-culled one."""
    state, fields, active, noise, bg, j_out = _jax_render(cull=True)
    t_state = state_from_numpy(**fields, active=active, active_sh_degree=3,
                               device="cpu")
    t_out = t_render(port_camera(W, H), t_state, to_t(bg), max_sh_degree=3,
                     noise=to_t(noise[active]), device="cpu")
    _compare(j_out, t_out, active)
    full = t_render(port_camera(W, H), t_state, to_t(bg), max_sh_degree=3,
                    noise=to_t(noise[active]), cull=False, device="cpu")
    assert t_out["num_pairs"] < full["num_pairs"]


def test_render_ply_round_trip(jax_render, tmp_path):
    """JAX save_ply → port load_ply renders as the JAX state does, and the
    port's save_ply is read back by the JAX load_ply unchanged."""
    state, fields, active, noise, bg, j_out = jax_render
    path = str(tmp_path / "point_cloud.ply")
    j_save_ply(state, path)
    t_state = t_load_ply(path, max_sh_degree=3, device="cpu")
    t_out = t_render(port_camera(W, H), t_state, to_t(bg), max_sh_degree=3,
                     noise=to_t(noise[active]), cull=False, device="cpu")
    _compare(j_out, t_out, active)

    path2 = str(tmp_path / "port.ply")
    t_save_ply(t_state, path2)
    back = j_load_ply(path2, max_sh_degree=3)
    n = int(active.sum())
    for f, v in fields.items():
        np.testing.assert_array_equal(np.asarray(getattr(back.params, f))[:n],
                                      v[active], err_msg=f)


def test_render_sh_degree_ramp():
    """A lower active SH degree masks the higher coefficients: the render
    equals one of the same state with those coefficients zeroed."""
    _, fields, active, noise, = _jax_state(n=40, cap=40, seed=3)[:4]
    cam = port_camera(W, H)
    bg = torch.zeros(3)
    s1 = state_from_numpy(**fields, active=active, active_sh_degree=1,
                          device="cpu")
    zeroed = dict(fields, features_rest=fields["features_rest"].copy())
    zeroed["features_rest"][:, 3:] = 0.0
    s2 = state_from_numpy(**zeroed, active=active, active_sh_degree=3,
                          device="cpu")
    a = t_render(cam, s1, bg, device="cpu")["render"]
    b = t_render(cam, s2, bg, device="cpu")["render"]
    assert torch.equal(a, b)
