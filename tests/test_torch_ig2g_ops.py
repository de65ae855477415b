"""The port's diffusion-editing math (gs2d_torch/ig2g/ops.py) against the
JAX package's (gs2d_tpu/ig2g/ops.py) on the same seeded inputs.

Bars: the schedule's tables and timesteps exact; fft_band,
normalize_latent_noise (every noise_reg), both guidance combiners, the
skip blend, DDIM add_noise/step and noise_calibration with a fixed
ε-predictor within 1e-6 (1e-5 where a sum of six terms or the loop's
FFTs carry the error); resize_bilinear, growing and shrinking (the VAE
brings 540 and 900 rows back as 536 and 896; 544→540 and 904→900
shrink), within 1e-6 of
``jax.image.resize(..., "bilinear")``'s own weights (antialiased when it
shrinks) applied in float64, and within 5e-5 of that function's float32
result on the CPU, which lies up to 2.9e-5 from the float64 product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_torch.ig2g import ops as T
from gs2d_tpu.ig2g import ops as J

from .test_torch_common import one_torch_thread  # noqa: F401

TOL = 1e-6


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol,
                               atol=tol)


def _rand(seed, shape, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + offset).astype(np.float32)


@pytest.mark.parametrize("steps,T_eff", [(20, None), (20, 700), (20, 980),
                                          (3, 853), (50, 17)])
def test_schedule_tables_and_timesteps_exact(steps, T_eff):
    j, t = J.DDIMSchedule(), T.DDIMSchedule()
    np.testing.assert_array_equal(t.alphas_cumprod.numpy(),
                                  np.asarray(j.alphas_cumprod))
    np.testing.assert_array_equal(t.set_timesteps(steps, T_eff),
                                  j.set_timesteps(steps, T_eff))
    assert t.step_ratio == j.step_ratio


def test_schedule_add_noise_and_step():
    j, t = J.DDIMSchedule(), T.DDIMSchedule()
    j.set_timesteps(20, 853)
    t.set_timesteps(20, 853)
    x0, noise, eps = (_rand(s, (1, 4, 8, 8)) for s in (0, 1, 2))
    for ts in (int(j.timesteps[0]), 421, int(j.timesteps[-1])):
        _close(t.add_noise(torch.as_tensor(x0), torch.as_tensor(noise), ts),
               j.add_noise(jnp.asarray(x0), jnp.asarray(noise), ts))
        _close(t.step(torch.as_tensor(eps), ts, torch.as_tensor(x0)),
               j.step(jnp.asarray(eps), ts, jnp.asarray(x0)))


@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 4, 17, 30)])
@pytest.mark.parametrize("scale", [0.5, 0.25, 1.0])
@pytest.mark.parametrize("is_low", [True, False])
def test_fft_band(shape, scale, is_low):
    x = _rand(3, shape)
    _close(T.fft_band(torch.as_tensor(x), scale, is_low),
           J.fft_band(jnp.asarray(x), scale, is_low))


@pytest.mark.parametrize("reg", ["None", "outlier", "scaling",
                                 "outlier-scaling"])
def test_normalize_latent_noise(reg):
    x = _rand(4, (2, 4, 16, 12), scale=5.0, offset=3.0)
    x[0, 1, 3, 4] = 60.0                      # an outlier for the clip
    kw = dict(use_outlier_clipping="outlier" in reg,
              use_scaling="scaling" in reg)
    _close(T.normalize_latent_noise(torch.as_tensor(x), **kw),
           J.normalize_latent_noise(jnp.asarray(x), **kw))


@pytest.mark.parametrize("mode", ["cfg", "cfg-simple"])
def test_guidance_combiners_and_skip_blend(mode):
    xs = [_rand(10 + i, (1, 4, 6, 7)) for i in range(6)]
    scales = (12.5, 1.5, 0.4, 0.2)
    _close(T.cfg_combine(*map(torch.as_tensor, xs[:3]), *scales[:2]),
           J.cfg_combine(*map(jnp.asarray, xs[:3]), *scales[:2]))
    _close(T.cfg_combine_rendered(*map(torch.as_tensor, xs), *scales,
                                  mode=mode),
           J.cfg_combine_rendered(*map(jnp.asarray, xs), *scales,
                                  mode=mode), tol=1e-5)
    with pytest.raises(ValueError):
        T.cfg_combine_rendered(*map(torch.as_tensor, xs), *scales,
                               mode="other")
    for lam in (0.0, 0.3, 1.0):
        _close(T.fuse_skip_residuals(torch.as_tensor(xs[0]),
                                     torch.as_tensor(xs[1]), lam),
               J.fuse_skip_residuals(jnp.asarray(xs[0]), jnp.asarray(xs[1]),
                                     lam))


@pytest.mark.parametrize("scale,is_low", [(1.0, False), (0.5, True)])
def test_noise_calibration_with_a_fixed_predictor(scale, is_low):
    """The calibration loop with the ε-predictor 0.5·x + 1e-4·t, the same
    function on both sides."""
    lat0, x_r, e0 = (_rand(20 + i, (1, 4, 12, 10)) for i in range(3))
    j, t = J.DDIMSchedule(), T.DDIMSchedule()
    j.set_timesteps(20, 900)
    t.set_timesteps(20, 900)
    t0 = int(j.timesteps[0])
    out_j = J.noise_calibration(jnp.asarray(lat0), jnp.asarray(x_r),
                                jnp.asarray(e0), j, t0,
                                lambda x, tt: 0.5 * x + 1e-4 * tt, scale,
                                is_low, 3)
    out_t = T.noise_calibration(torch.as_tensor(lat0), torch.as_tensor(x_r),
                                torch.as_tensor(e0), t, t0,
                                lambda x, tt: 0.5 * x + 1e-4 * tt, scale,
                                is_low, 3)
    for a, b in zip(out_t, out_j):
        _close(a, b, tol=1e-5 * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("src,dst", [((544, 24), (540, 24)),
                                     ((904, 16), (900, 16)),
                                     ((536, 24), (540, 24)),
                                     ((896, 16), (900, 16)),
                                     ((17, 9), (33, 20)),
                                     ((40, 64), (25, 31)),
                                     ((8, 8), (8, 8))])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    """Within 1e-6 of JAX's own weight matrices (``compute_weight_mat``,
    float32, exact equal to the port's) applied in float64 (the port lies
    7e-8 from it); within 5e-5 of ``jax.image.resize`` itself, whose
    float32 contraction on the CPU lies up to 2.9e-5 from that float64
    product (896→900 rows; 7.0e-6 at 544→540)."""
    from jax._src.image.scale import (_fill_triangle_kernel,
                                      compute_weight_mat)
    x = np.random.default_rng(5).random((1, 3) + src).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 3) + dst, method="bilinear")
    got = T.resize_bilinear(torch.as_tensor(x), dst)
    assert tuple(got.shape) == (1, 3) + dst
    exact = x.astype(np.float64)
    for axis, (n_in, n_out) in ((2, (src[0], dst[0])), (3, (src[1], dst[1]))):
        if n_in == n_out:
            continue
        w = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                          _fill_triangle_kernel, True))
        np.testing.assert_array_equal(
            T._triangle_weights(n_in, n_out, "cpu").numpy(), w)
        exact = np.moveaxis(np.tensordot(exact, w.astype(np.float64),
                                         axes=([axis], [0])), -1, axis)
    _close(got, exact)
    _close(got, ref, tol=5e-5)
