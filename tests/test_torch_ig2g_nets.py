"""The port's SD networks (gs2d_torch/ig2g/{sdnet,vae,clip_text}.py)
against the JAX package's, at the TINY configs, with the JAX
``init_params`` carried across by name (``sd_weights.carry_params``).

Bar: rtol 1e-4 / atol 1e-5 against the JAX outputs (``unet_apply`` with
and without FreeU, every skip of ``unet_apply_intermediate``,
``unet_apply_fused`` at λ ∈ {0, 0.3, 1}, ``vae_encode_moments``,
``vae_decode``, ``clip_text_apply``) at latent sides the JAX UNet accepts.
At sides that are not a multiple of 2^(n_blocks−1) the JAX UNet raises
and the port runs, its upsample equal to ``F.interpolate(size=skip,
mode="nearest")``. The full SD-1.5 modules are built on the meta device
(no memory): their state dicts are the JAX shape specs, with the
published parameter counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gs2d_torch.ig2g import clip_text as TC
from gs2d_torch.ig2g import sdnet as T
from gs2d_torch.ig2g import vae as TV
from gs2d_torch.ig2g.sd_weights import carry_params
from gs2d_tpu.ig2g import clip_text as JC
from gs2d_tpu.ig2g import sdnet as J
from gs2d_tpu.ig2g import vae as JV

from .test_torch_common import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def _np(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def unet_pair():
    jp = J.init_params(J.unet_param_shapes(J.TINY_UNET),
                       jax.random.PRNGKey(0))
    return jp, carry_params(T.UNet2DCondition(T.TINY_UNET, device="cpu"),
                            _np(jp), "unet", "cpu")


@pytest.fixture(scope="module")
def vae_pair():
    jp = J.init_params(JV.vae_param_shapes(JV.TINY_VAE),
                       jax.random.PRNGKey(1))
    return jp, carry_params(TV.AutoencoderKL(TV.TINY_VAE, device="cpu"),
                            _np(jp), "vae", "cpu")


def _sample(h, w, b=3, seed=7, in_ch=8, ctx_dim=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, in_ch, h, w)).astype(np.float32),
            rng.normal(size=(b, 5, ctx_dim)).astype(np.float32))


@pytest.mark.parametrize("t", [10, 500, 961])
@pytest.mark.parametrize("freeu", [None, J.FreeUParams(),
                                   J.FreeUParams(b1=1.5, b2=1.6, s1=0.5,
                                                 s2=0.4)])
def test_unet_apply(unet_pair, t, freeu):
    jp, unet = unet_pair
    x, ctx = _sample(16, 12)
    ref = J.unet_apply(J.TINY_UNET, jp, jnp.asarray(x), t, jnp.asarray(ctx),
                       freeu=freeu)
    tf = None if freeu is None else T.FreeUParams(**freeu.__dict__)
    with torch.no_grad():
        got = T.unet_apply(unet, torch.as_tensor(x), t, torch.as_tensor(ctx),
                           freeu=tf)
    _close(got, ref)


def test_unet_apply_intermediate_every_skip(unet_pair):
    jp, unet = unet_pair
    x, ctx = _sample(16, 16)
    ref = J.unet_apply_intermediate(J.TINY_UNET, jp, jnp.asarray(x), 300,
                                    jnp.asarray(ctx))
    with torch.no_grad():
        got = T.unet_apply_intermediate(unet, torch.as_tensor(x), 300,
                                        torch.as_tensor(ctx))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        _close(g, r)


@pytest.mark.parametrize("lam", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("freeu", [False, True])
def test_unet_apply_fused(unet_pair, lam, freeu):
    jp, unet = unet_pair
    x, ctx = _sample(16, 12)
    x2 = x + 0.5
    fj = J.FreeUParams() if freeu else None
    ft = T.FreeUParams() if freeu else None
    skips_j = J.unet_apply_intermediate(J.TINY_UNET, jp, jnp.asarray(x2),
                                        200, jnp.asarray(ctx))
    ref = J.unet_apply_fused(J.TINY_UNET, jp, jnp.asarray(x), skips_j, lam,
                             200, jnp.asarray(ctx), freeu=fj)
    with torch.no_grad():
        skips_t = T.unet_apply_intermediate(unet, torch.as_tensor(x2), 200,
                                            torch.as_tensor(ctx))
        got = T.unet_apply_fused(unet, torch.as_tensor(x), skips_t, lam, 200,
                                 torch.as_tensor(ctx), freeu=ft)
        if lam == 0.0:
            plain = T.unet_apply(unet, torch.as_tensor(x), 200,
                                 torch.as_tensor(ctx), freeu=ft)
            np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)
    _close(got, ref)


def test_unet_runs_where_the_jax_unet_cannot(unet_pair):
    """A 16×9 latent (9 is odd; TINY_UNET halves once): the JAX UNet's
    concatenation fails, the port upsamples to the skip's size as
    diffusers does, and its output has the input's size."""
    jp, unet = unet_pair
    x, ctx = _sample(16, 9)
    with pytest.raises(TypeError, match="concatenate"):
        J.unet_apply(J.TINY_UNET, jp, jnp.asarray(x), 100, jnp.asarray(ctx))
    seen = {}
    up = unet.up_blocks[0]
    hooks = [up.resnets[-1].register_forward_hook(
                 lambda m, i, o: seen.__setitem__("before", o)),
             up.upsamplers[0].conv.register_forward_pre_hook(
                 lambda m, i: seen.__setitem__("after", i[0]))]
    try:
        with torch.no_grad():
            out = T.unet_apply(unet, torch.as_tensor(x), 100,
                               torch.as_tensor(ctx))
    finally:
        for h in hooks:
            h.remove()
    assert tuple(out.shape) == (3, 4, 16, 9)
    assert bool(torch.isfinite(out).all())
    assert tuple(seen["before"].shape[-2:]) == (8, 5)
    torch.testing.assert_close(seen["after"], F.interpolate(
        seen["before"], size=(16, 9), mode="nearest"), rtol=0, atol=0)


def test_four_level_unet_at_a_960x540_views_latent():
    """A 4-level UNet (SD-1.5's depth, tiny widths) at the latent of a
    960×540 view, 67×120: 67 → 34 → 17 → 9 on the way down, so the JAX
    UNet fails and the port comes back to 67×120."""
    cfg = J.UNetConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                       cross_attention_dim=16, num_attention_heads=2,
                       norm_groups=4)
    jp = J.init_params(J.unet_param_shapes(cfg), jax.random.PRNGKey(3))
    unet = carry_params(T.UNet2DCondition(T.UNetConfig(**cfg.__dict__),
                                          device="cpu"), _np(jp), "unet",
                        "cpu")
    x, ctx = _sample(67, 120, b=1)
    with pytest.raises(TypeError, match="concatenate"):
        J.unet_apply(cfg, jp, jnp.asarray(x), 100, jnp.asarray(ctx))
    with torch.no_grad():
        skips = T.unet_apply_intermediate(unet, torch.as_tensor(x), 100,
                                          torch.as_tensor(ctx))
        out = T.unet_apply(unet, torch.as_tensor(x), 100,
                           torch.as_tensor(ctx))
    assert [tuple(s.shape[-2:]) for s in skips][::2] == [
        (67, 120), (34, 60), (17, 30), (9, 15)]
    assert tuple(out.shape) == (1, 4, 67, 120)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("hw", [(64, 64), (36, 44), (45, 27)])
def test_vae_encode_moments_and_decode(vae_pair, hw):
    jp, vae = vae_pair
    rng = np.random.default_rng(11)
    img = (rng.random((2, 3) + hw) * 2 - 1).astype(np.float32)
    mj = JV.vae_encode_moments(JV.TINY_VAE, jp, jnp.asarray(img))
    with torch.no_grad():
        mt = TV.vae_encode_moments(vae, torch.as_tensor(img))
    for a, b in zip(mt, mj):
        assert tuple(a.shape) == b.shape
        _close(a, b)
    lat = rng.normal(size=(2, 4) + tuple(mj[0].shape[2:])).astype(np.float32)
    ref = JV.vae_decode(JV.TINY_VAE, jp, jnp.asarray(lat))
    with torch.no_grad():
        got = TV.vae_decode(vae, torch.as_tensor(lat))
    assert tuple(got.shape) == ref.shape
    _close(got, ref)
    noise = rng.normal(size=mj[0].shape).astype(np.float32)
    _close(TV.vae_sample(*mt, torch.as_tensor(noise)),
           mj[0] + jnp.exp(0.5 * jnp.clip(mj[1], -30.0, 20.0)) * noise)


@pytest.mark.parametrize("rows,lat_rows", [(540, 67), (900, 112)])
def test_vae_rows_of_a_view(vae_pair, rows, lat_rows):
    """The (0, 1, 0, 1) pad before each stride-2 conv: 540 rows → 270 →
    135 → 67 latent rows → 536 decoded; 900 → 112 → 896."""
    jp, vae = vae_pair
    ref = JV.vae_encode_moments(JV.TINY_VAE, jp, jnp.zeros((1, 3, rows, 16)))
    with torch.no_grad():
        mean, _ = TV.vae_encode_moments(vae, torch.zeros(1, 3, rows, 16))
        assert tuple(mean.shape) == ref[0].shape == (1, 4, lat_rows, 2)
        assert tuple(TV.vae_decode(vae, mean).shape) == (1, 3, 8 * lat_rows,
                                                         16)


def test_clip_text_apply():
    jp = J.init_params(JC.clip_param_shapes(JC.TINY_CLIP),
                       jax.random.PRNGKey(2))
    model = carry_params(TC.CLIPTextModel(TC.TINY_CLIP, device="cpu"),
                         _np(jp), "clip", "cpu")
    ids = np.random.default_rng(3).integers(0, 64, size=(3, 8))
    ref = JC.clip_text_apply(JC.TINY_CLIP, jp, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = TC.clip_text_apply(model, torch.as_tensor(ids))
    _close(got, ref)


@pytest.mark.parametrize("which", ["unet", "vae", "clip"])
def test_sd15_modules_match_the_shape_specs_and_counts(which):
    """SD-1.5 at full width, built on the meta device: state-dict names
    and shapes equal to the JAX specs (tests/test_sdnet.py pins the same
    counts), without allocating."""
    build, spec, cfg, count = {
        "unet": (T.UNet2DCondition, J.unet_param_shapes, T.SD15_IP2P_UNET,
                 859_532_484),
        "vae": (TV.AutoencoderKL, JV.vae_param_shapes, TV.SD15_VAE,
                83_653_863),
        "clip": (TC.CLIPTextModel, JC.clip_param_shapes, TC.SD15_CLIP,
                 123_060_480)}[which]
    m = build(cfg, device="meta")
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    jcfg = {"unet": J.SD15_IP2P_UNET, "vae": JV.SD15_VAE,
            "clip": JC.SD15_CLIP}[which]
    assert shapes == spec(jcfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == count


def test_carry_params_checks(vae_pair):
    """A missing name and a wrong shape raise naming it; the legacy VAE
    attention names ({query,key,value,proj_attn}, as (C, C, 1, 1)
    convolutions) load as diffusers' to_q/to_k/to_v/to_out.0."""
    jp, vae = vae_pair
    raw = _np(jp)
    bad = dict(raw)
    del bad["decoder.conv_out.bias"]
    with pytest.raises(ValueError, match="decoder.conv_out.bias"):
        carry_params(TV.AutoencoderKL(TV.TINY_VAE, device="meta"), bad,
                     "vae", "cpu")
    bad = dict(raw)
    bad["encoder.conv_in.weight"] = bad["encoder.conv_in.weight"][:, :1]
    with pytest.raises(ValueError, match="encoder.conv_in.weight"):
        carry_params(TV.AutoencoderKL(TV.TINY_VAE, device="meta"), bad,
                     "vae", "cpu")
    legacy = {}
    for k, v in raw.items():
        for new, old in ((".to_q.", ".query."), (".to_k.", ".key."),
                         (".to_v.", ".value."), (".to_out.0.",
                                                 ".proj_attn.")):
            if new in k and "attentions" in k:
                k = k.replace(new, old)
                v = v[:, :, None, None] if v.ndim == 2 else v
        legacy[k] = v
    assert any(".query." in k for k in legacy)
    got = carry_params(TV.AutoencoderKL(TV.TINY_VAE, device="meta"), legacy,
                       "vae", "cpu")
    for k, v in vae.state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
