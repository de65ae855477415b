"""The port's InstructPix2Pix against the benchmark's plain PyTorch
reference (``perfbench/reference/ip2p.py``), which is written from the
published SD-1.5 description and imports nothing of the port, on seeded
random weights at a small size on the CPU, in float32.

- The UNet at TINY widths and a three-level variant with two ResNets a
  level, at odd latent sides (9x7, 13x5: every level's side is odd, the
  up path upsamples to the skip's size); the VAE's moments and decode on
  an odd-sized image; the DDIM schedule's timesteps, one DDIM step with
  IP2P's 3-way guidance, and one whole ``encoded-normalized`` edit with
  the port's draws replayed into the reference. Bars: 1e-5 of the
  largest value (the two sides run the same operations in float32; the
  order of a sum may differ).
- ``perfbench/counts/sd_unet.py``'s operations equal
  ``torch.utils.flop_counter.FlopCounterMode`` on the reference UNet,
  and its parameter count the port's at TINY and at SD-1.5 widths.
- The float16 path: weights and activations half, outputs finite, the
  edit's image float32; a non-finite UNet output raises at the edit's
  decode.
"""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gs2d_torch.ig2g import ip2p, sdnet, vae
from gs2d_torch.ig2g.ops import DDIMSchedule, cfg_combine
from gs2d_torch.ig2g.sd_weights import carry_params
from perfbench.counts import sd_unet
from perfbench.reference import ip2p as ref

from .test_torch_common import one_torch_thread  # noqa: F401

THREE = sdnet.UNetConfig(block_out_channels=(8, 16, 16), layers_per_block=2,
                         cross_attention_dim=16, num_attention_heads=2,
                         norm_groups=4)
BAR = 1e-5


def _dict(cfg) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in vars(cfg).items()}


def _weights(shapes, seed):
    """init_params' draws, with the unit norms and zero biases jittered
    so that every parameter is exercised."""
    g = torch.Generator().manual_seed(seed)
    w = sdnet.init_params(shapes, g, device="cpu")
    return {k: v + 0.05 * torch.randn(v.shape, generator=g) if v.dim() == 1
            else v for k, v in w.items()}


def _unet(cfg, w, dtype=torch.float32):
    return carry_params(sdnet.UNet2DCondition(cfg, device="meta"), w, "unet",
                        "cpu", dtype)


def _vae(w, dtype=torch.float32):
    return carry_params(vae.AutoencoderKL(vae.TINY_VAE, device="meta"), w,
                        "vae", "cpu", dtype)


def _close(got, want):
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= BAR * float(want.abs().max()), err


@pytest.mark.parametrize("cfg", [sdnet.TINY_UNET, THREE],
                         ids=["tiny", "three_levels"])
@pytest.mark.parametrize("hw", [(9, 7), (13, 5)])
def test_unet_matches_the_reference(cfg, hw):
    w = _weights(sdnet.unet_param_shapes(cfg), 1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 8, *hw), generator=g)
    ctx = torch.randn((3, 5, cfg.cross_attention_dim), generator=g)
    with torch.no_grad():
        got = _unet(cfg, w)(x, 617, ctx)
        want = ref.unet(w, x, 617, ctx, _dict(cfg))
    _close(got, want)


def test_vae_matches_the_reference():
    w = _weights(vae.vae_param_shapes(vae.TINY_VAE), 3)
    m = _vae(w)
    g = torch.Generator().manual_seed(4)
    img = torch.rand((1, 3, 45, 27), generator=g) * 2 - 1
    lat = torch.randn((1, 4, 6, 4), generator=g)
    with torch.no_grad():
        mean, logvar = vae.vae_encode_moments(m, img)
        r_mean, r_logvar = ref.vae_moments(w, img, _dict(vae.TINY_VAE))
        assert mean.shape == (1, 4, 5, 3)
        _close(mean, r_mean)
        _close(logvar, r_logvar)
        _close(vae.vae_decode(m, lat),
               ref.vae_decode(w, lat, _dict(vae.TINY_VAE)))


@pytest.mark.parametrize("T", [700, 853, 980])
def test_one_ddim_step_with_guidance(T):
    sched = DDIMSchedule()
    ts = sched.set_timesteps(20, effective_train_timesteps=T)
    r_ts, ratio = ref.timesteps(T, 20)
    assert list(ts) == r_ts and sched.step_ratio == ratio
    ac = ref.alphas_cumprod()
    torch.testing.assert_close(sched.alphas_cumprod, ac, rtol=2e-6, atol=0)
    g = torch.Generator().manual_seed(T)
    x = torch.randn((1, 4, 5, 3), generator=g)
    e = torch.randn((3, 4, 5, 3), generator=g)
    for t in (r_ts[0], r_ts[-1]):
        got = sched.step(cfg_combine(e[0:1], e[1:2], e[2:3], 12.5, 1.5), t,
                         x)
        eps = e[2:3] + 12.5 * (e[0:1] - e[1:2]) + 1.5 * (e[1:2] - e[2:3])
        _close(got, ref.ddim_step(ac, eps, t, ratio, x))


def test_one_whole_edit_matches_the_reference():
    w_u = _weights(sdnet.unet_param_shapes(sdnet.TINY_UNET), 5)
    w_v = _weights(vae.vae_param_shapes(vae.TINY_VAE), 6)
    g = torch.Generator().manual_seed(7)
    img, cond, noise = (torch.rand((1, 3, 40, 24), generator=g)
                        for _ in range(3))
    text = torch.randn((3, 5, 16), generator=g)
    be = ip2p.TorchSDBackend(unet=_unet(sdnet.TINY_UNET, w_u), vae=_vae(w_v),
                             device="cpu")
    ed = ip2p.InstructPix2Pix(ip2p.IP2PParams(
        diffusion_steps=6, noise_type="encoded-normalized"), backend=be,
        seed=11, device="cpu")
    got = ed.edit_image(text, img, cond, noise)
    draws = ip2p.Draws(11, "cpu")
    T = draws.timestep(700, 980)
    with torch.no_grad():
        want = ref.edit(w_u, w_v, img, cond, noise, text, T,
                        draws.posterior((1, 4, 5, 3)), steps=6,
                        unet_cfg=_dict(sdnet.TINY_UNET),
                        vae_cfg=_dict(vae.TINY_VAE))
    assert got.dtype == torch.float32 and got.shape == (1, 3, 40, 24)
    _close(got, want)


@pytest.mark.parametrize("cfg,hw,ctx_len", [
    (sdnet.TINY_UNET, (9, 7), 5), (THREE, (13, 5), 4), (THREE, (2, 3), 77)])
def test_counts_match_the_flop_counter(cfg, hw, ctx_len):
    shapes = sdnet.unet_param_shapes(cfg)
    w = sdnet.init_params(shapes, torch.Generator().manual_seed(8),
                          device="cpu")
    x = torch.randn((3, 8, *hw))
    ctx = torch.randn((3, ctx_len, cfg.cross_attention_dim))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.unet(w, x, 300, ctx, _dict(cfg))
    c = sd_unet.unet_call(_dict(cfg), 3, hw, ctx_len)
    assert c["flops"] == fc.get_total_flops()
    assert c["params"] == sum(math.prod(s) for s in shapes.values())


def test_counts_at_the_published_widths():
    """859,532,484 parameters (chip_smoke.py's gate); 26.4 TFLOP a call of
    the batch of 3 at a 1557x1038 view's 129x194 latent."""
    cfg = _dict(sdnet.SD15_IP2P_UNET)
    hw = [sd_unet.latent_side(s) for s in (1038, 1557)]
    assert hw == [129, 194]
    c = sd_unet.unet_call(cfg, 3, hw)
    assert c["params"] == 859_532_484 == sum(
        math.prod(s) for s in sdnet.unet_param_shapes(
            sdnet.SD15_IP2P_UNET).values())
    assert 26.3e12 < c["flops"] < 26.5e12
    assert c["seconds"] == c["flops"] / sd_unet.PEAK_FP16_FLOPS


def test_the_float16_path():
    w_u = _weights(sdnet.unet_param_shapes(sdnet.TINY_UNET), 9)
    w_v = _weights(vae.vae_param_shapes(vae.TINY_VAE), 10)
    unet, vae_m = _unet(sdnet.TINY_UNET, w_u, torch.float16), \
        _vae(w_v, torch.float16)
    assert {p.dtype for p in unet.parameters()} == {torch.float16}
    assert {p.dtype for p in vae_m.parameters()} == {torch.float16}
    seen = set()
    for m in (*unet.modules(), *vae_m.modules()):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                          torch.nn.GroupNorm, torch.nn.LayerNorm)):
            m.register_forward_hook(lambda m, a, out: seen.add(out.dtype))
    g = torch.Generator().manual_seed(12)
    img, cond, noise = (torch.rand((1, 3, 40, 24), generator=g)
                        for _ in range(3))
    text = torch.randn((3, 5, 16), generator=g)
    ed = ip2p.InstructPix2Pix(ip2p.IP2PParams(
        diffusion_steps=4, noise_type="encoded-normalized"),
        backend=ip2p.TorchSDBackend(unet=unet, vae=vae_m, device="cpu"),
        seed=13, device="cpu")
    out = ed.edit_image(text, img, cond, noise)
    assert seen == {torch.float16}
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    # the half-precision run stays near the float32 one
    ed32 = ip2p.InstructPix2Pix(ip2p.IP2PParams(
        diffusion_steps=4, noise_type="encoded-normalized"),
        backend=ip2p.TorchSDBackend(unet=_unet(sdnet.TINY_UNET, w_u),
                                    vae=_vae(w_v), device="cpu"),
        seed=13, device="cpu")
    out32 = ed32.edit_image(text, img, cond, noise)
    assert float((out - out32).abs().mean()) < 1e-2


def test_a_non_finite_unet_output_raises():
    w_u = _weights(sdnet.unet_param_shapes(sdnet.TINY_UNET), 14)
    w_u["conv_out.bias"] = torch.full_like(w_u["conv_out.bias"],
                                           float("inf"))
    w_v = _weights(vae.vae_param_shapes(vae.TINY_VAE), 15)
    ed = ip2p.InstructPix2Pix(ip2p.IP2PParams(
        diffusion_steps=2, noise_type="encoded-normalized"),
        backend=ip2p.TorchSDBackend(unet=_unet(sdnet.TINY_UNET, w_u),
                                    vae=_vae(w_v), device="cpu"),
        seed=16, device="cpu")
    img = torch.rand((1, 3, 40, 24))
    with pytest.raises(FloatingPointError, match="not finite"):
        ed.edit_image(torch.randn((3, 5, 16)), img, img, img)
