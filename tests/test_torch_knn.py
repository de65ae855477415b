"""Port parity of model init: ``gs2d_torch.ops.knn.mean_sq_dist3`` and
``gs2d_torch.models.gaussians.init_from_pcd`` against the JAX package's on
the same seeded points.

Bars: the k-NN mean squared distance at 1e-5 absolute against the JAX
package's (its ‖a‖² + ‖b‖² − 2a·b form is off a float64 search by up to
~7e-5 relative on these clouds) and at 1e-6 relative against a float64
search; init's positions, rotations, colours, opacities and SH rest
exactly as NumPy draws and converts them, its log-scales at 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gs2d_torch.models.gaussians import init_from_pcd as t_init
from gs2d_torch.ops.knn import mean_sq_dist3 as t_knn
from gs2d_tpu.models.gaussians import init_from_pcd as j_init
from gs2d_tpu.ops.knn import mean_sq_dist3 as j_knn

from .test_torch_common import to_t


def _points(n, seed, dup=0):
    pts = np.random.default_rng(seed).uniform(-1, 1, (n, 3)) \
        .astype(np.float32)
    pts[n - dup:] = pts[:dup]            # exact duplicates of the first rows
    return pts


@pytest.mark.parametrize("n,dup,block", [(300, 0, 1024), (2500, 40, 1024),
                                         (700, 7, 128)])
def test_mean_sq_dist3_matches_jax(n, dup, block):
    pts = _points(n, n, dup)
    got = t_knn(to_t(pts), block=block).numpy()
    ref = np.asarray(j_knn(jnp.asarray(pts)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert got.shape == (n,) and np.isfinite(got).all()
    p64 = pts.astype(np.float64)
    d2 = np.sum((p64[:, None] - p64[None]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    exact = np.sort(d2, axis=1)[:, :3].mean(axis=1)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)


def test_mean_sq_dist3_with_fewer_than_three_neighbours():
    for n in (1, 2, 3):
        pts = _points(n, 0)
        got = t_knn(to_t(pts)).numpy()
        ref = np.asarray(j_knn(jnp.asarray(pts)))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        np.testing.assert_allclose(got[np.isfinite(ref)],
                                   ref[np.isfinite(ref)], rtol=1e-5)


@pytest.mark.parametrize("sh", [0, 3])
def test_init_from_pcd_matches_jax(sh):
    n, cap = 500, 640
    pts = _points(n, 11, dup=5)
    cols = np.random.default_rng(12).random((n, 3)).astype(np.float32)
    j = j_init(pts, cols, cap, max_sh_degree=sh, seed=3)
    t = t_init(pts, cols, max_sh_degree=sh, seed=3, device="cpu")
    act = np.asarray(j.active)
    assert act.sum() == n and t.active_sh_degree == int(j.active_sh_degree)
    for f in ("xyz", "features_dc", "features_rest", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(t.params, f).numpy(),
                                      np.asarray(getattr(j.params, f))[act],
                                      err_msg=f)
    np.testing.assert_allclose(t.params.scaling.numpy(),
                               np.asarray(j.params.scaling)[act],
                               rtol=1e-6, atol=1e-6)
    # given scales are taken as they are
    s = np.log(np.random.default_rng(13).uniform(0.01, 0.1, (n, 2)))
    t2 = t_init(pts, cols, max_sh_degree=sh, init_scales=s, seed=3,
                device="cpu")
    j2 = j_init(pts, cols, cap, max_sh_degree=sh, init_scales=s, seed=3)
    np.testing.assert_array_equal(t2.params.scaling.numpy(),
                                  np.asarray(j2.params.scaling)[act])
