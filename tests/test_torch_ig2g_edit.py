"""``edit_image`` of the port's InstructPix2Pix (gs2d_torch/ig2g/ip2p.py)
against the JAX package's on the same inputs, with the JAX draws replayed
into the port (``JaxDraws``: ``PRNGKey(seed)`` split for T and the
Gaussian noise as ``ip2p.py:246-248`` does, and the SD backend's
``PRNGKey(seed ^ 0x5EED)`` split for each posterior sample).

Every noise type ('None', 'encoded', 'encoded-normalized', 'concat'),
every freeu_mode ('None', 'intermediate', 'intermediate-reverse', 'cfg')
and noise calibration, with the stub backend (bar 1e-5; measured at most
4.8e-7) and with a TINY_UNET / TINY_VAE SD backend carried across from the
JAX params (bar 1e-5 on the [0, 1] image; measured at most 4.4e-6, on
'encoded'), one case of it with FreeU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2d_torch.ig2g import ip2p as T
from gs2d_torch.ig2g import sdnet as TS
from gs2d_torch.ig2g import vae as TV
from gs2d_torch.ig2g.sd_weights import carry_params
from gs2d_tpu.ig2g import ip2p as J
from gs2d_tpu.ig2g import sdnet as JS
from gs2d_tpu.ig2g import vae as JV

from .test_torch_common import one_torch_thread  # noqa: F401

STUB_TOL = 1e-5
SD_TOL = 1e-5


class JaxDraws:
    """The port's ``Draws`` interface, replaying the JAX editor's draws:
    its key ``PRNGKey(seed)`` split once per draw (T, then the noise), and
    the SD backend's ``PRNGKey(seed ^ 0x5EED)`` split once per posterior
    sample."""

    def __init__(self, seed, device="cpu"):
        self.key = jax.random.PRNGKey(seed)
        self.backend_key = jax.random.PRNGKey(seed ^ 0x5EED)

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def timestep(self, lo, hi):
        return int(jax.random.randint(self._split(), (), lo, hi + 1))

    def normal(self, shape):
        return torch.as_tensor(np.array(jax.random.normal(
            self._split(), tuple(shape))))

    def posterior(self, shape):
        self.backend_key, sub = jax.random.split(self.backend_key)
        return torch.as_tensor(np.array(jax.random.normal(sub,
                                                          tuple(shape))))


CASES = [  # noise_type, freeu_mode, noise calibration
    ("None", "None", False),
    ("encoded", "None", False),
    ("encoded-normalized", "None", False),
    ("concat", "None", False),
    ("encoded", "intermediate", False),
    ("encoded-normalized", "intermediate-reverse", False),
    ("encoded", "cfg", False),
    ("None", "None", True),
]


def _inputs(H=32, W=32):
    rng = np.random.default_rng(0)
    img, cond, noise = (rng.random((1, 3, H, W)).astype(np.float32)
                        for _ in range(3))
    ctx = rng.normal(size=(3, 5, 16)).astype(np.float32)
    return img, cond, noise, ctx


def _params(noise_type, freeu_mode, calib, steps):
    return dict(diffusion_steps=steps, noise_type=noise_type,
                freeu_mode=freeu_mode, is_noise_calibration=calib,
                noise_guidance_scale=0.5, noise_guidance_scale2=0.25,
                lambda_intermediate=0.7)


def _edit_pair(j_backend, t_backend, kw, seed, ctx):
    img, cond, noise, ctx_np = _inputs()
    j = J.InstructPix2Pix(J.IP2PParams(**kw), backend=j_backend, seed=seed)
    t = T.InstructPix2Pix(T.IP2PParams(**kw), backend=t_backend, seed=seed,
                          device="cpu")
    t.draws = JaxDraws(seed)
    ref = np.asarray(j.edit_image(None if ctx is None else jnp.asarray(ctx),
                                  jnp.asarray(img), jnp.asarray(cond),
                                  jnp.asarray(noise)))
    got = t.edit_image(None if ctx is None else torch.as_tensor(ctx),
                       torch.as_tensor(img), torch.as_tensor(cond),
                       torch.as_tensor(noise)).numpy()
    return got, ref


@pytest.mark.parametrize("noise_type,freeu_mode,calib", CASES)
def test_edit_image_stub(noise_type, freeu_mode, calib):
    got, ref = _edit_pair("stub", "stub",
                          _params(noise_type, freeu_mode, calib, 20), 3,
                          None)
    assert got.shape == ref.shape == (1, 3, 32, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=STUB_TOL)


EDITOR_KNOBS = ("guidance_scale", "image_guidance_scale", "diffusion_steps",
                "lower_bound", "upper_bound", "noise_type", "noise_reg",
                "freeu_mode", "lambda_intermediate")


@pytest.mark.parametrize("knobs", [
    {},
    dict(noise_type="encoded-normalized", guidance_scale=9.0,
         image_guidance_scale=2.0, diffusion_steps=5, lower_bound=0.5,
         upper_bound=0.9, noise_reg="outlier", freeu_mode="intermediate",
         lambda_intermediate=0.3)])
def test_build_editor_matches_jax(knobs):
    """The JAX configuration's editor knobs (pipeline-level fields that
    override its ``ip2p``) and the port's (``IP2PParams`` alone) build the
    same editor: equal parameters, the stub backend, and the same edit
    (bar 1e-5, as the stub cases) with the JAX draws replayed."""
    import dataclasses

    from gs2d_torch.ig2g.pipeline import IG2GPipelineConfig, build_editor
    from gs2d_tpu.ig2g import pipeline as JP
    j = JP.build_editor(JP.IG2GPipelineConfig(text_prompt="make it snowy",
                                              **knobs))
    t = build_editor(IG2GPipelineConfig(ip2p=T.IP2PParams(
        **{k: getattr(j.p, k) for k in EDITOR_KNOBS})), seed=0,
        device="cpu")
    assert dataclasses.asdict(t.p) == dataclasses.asdict(j.p)
    for k, v in knobs.items():
        assert getattr(t.p, k) == v
    assert isinstance(j.backend, J.StubBackend)
    assert isinstance(t.backend, T.StubBackend)
    t.draws = JaxDraws(0)
    img, cond, noise, _ = _inputs()
    ref = np.asarray(j.edit_image(None, jnp.asarray(img), jnp.asarray(cond),
                                  jnp.asarray(noise)))
    got = t.edit_image(None, torch.as_tensor(img), torch.as_tensor(cond),
                       torch.as_tensor(noise)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=STUB_TOL)


@pytest.fixture(scope="module")
def sd_backends():
    """A JAX SD backend (its jitted UNet/VAE shared by the cases, its key
    reset per case) and the port's, carried across; the same with FreeU."""
    jp_u = JS.init_params(JS.unet_param_shapes(JS.TINY_UNET),
                          jax.random.PRNGKey(0))
    jp_v = JS.init_params(JV.vae_param_shapes(JV.TINY_VAE),
                          jax.random.PRNGKey(1))
    unet = carry_params(TS.UNet2DCondition(TS.TINY_UNET, device="cpu"),
                        {k: np.asarray(v) for k, v in jp_u.items()}, "unet",
                        "cpu")
    vae = carry_params(TV.AutoencoderKL(TV.TINY_VAE, device="cpu"),
                       {k: np.asarray(v) for k, v in jp_v.items()}, "vae",
                       "cpu")
    out = {}
    for freeu in (None, JS.FreeUParams()):
        out[freeu is not None] = (
            J.JaxSDBackend(unet_cfg=JS.TINY_UNET, vae_cfg=JV.TINY_VAE,
                           unet_params=jp_u, vae_params=jp_v, freeu=freeu),
            T.TorchSDBackend(unet=unet, vae=vae, device="cpu",
                             freeu=None if freeu is None
                             else TS.FreeUParams()))
    return out


@pytest.mark.parametrize("noise_type,freeu_mode,calib,freeu",
                         [c + (False,) for c in CASES]
                         + [("encoded-normalized", "intermediate", False,
                             True)])
def test_edit_image_sd_backend(sd_backends, noise_type, freeu_mode, calib,
                               freeu):
    seed = 5
    j_be, t_be = sd_backends[freeu]
    j_be._key = jax.random.PRNGKey(seed ^ 0x5EED)
    _, _, _, ctx = _inputs()
    got, ref = _edit_pair(j_be, t_be,
                          _params(noise_type, freeu_mode, calib, 3), seed,
                          ctx)
    assert got.shape == ref.shape == (1, 3, 32, 32)
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=SD_TOL)
