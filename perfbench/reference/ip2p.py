"""Plain PyTorch reference of an InstructPix2Pix edit, in float32.

InstructPix2Pix (Brooks et al., arXiv:2211.09800; the weights
timbrooks/instruct-pix2pix) is Stable Diffusion 1.5 with 8 input
channels, run as diffusers' ``StableDiffusionInstructPix2PixPipeline``
runs it. This file is written from the published architecture
(diffusers' ``UNet2DConditionModel`` and ``AutoencoderKL`` with the
SD-1.5 configuration, ``DDIMScheduler``) and holds:

- the UNet2DCondition: ``conv_in``; a sinusoidal timestep embedding
  (flip_sin_to_cos, shift 0) through a two-layer SiLU MLP; down blocks
  of ``layers_per_block`` ResNets each (GroupNorm, SiLU, 3x3 conv, the
  projected time embedding added, GroupNorm, SiLU, 3x3 conv, a 1x1
  shortcut where the widths differ), every level but the last with a
  Transformer2D after each ResNet (GroupNorm eps 1e-6, 1x1 ``proj_in``,
  self-attention, cross-attention against the text states, a GEGLU
  feed-forward of four times the width, each after a LayerNorm and added
  back, 1x1 ``proj_out`` and the residual) and a stride-2 3x3
  downsampling conv; a mid block (ResNet, Transformer2D, ResNet); up
  blocks of ``layers_per_block + 1`` ResNets over the concatenated skips,
  with transformers on every level but the first and, but on the last,
  a nearest upsampling to the size of the next skip (diffusers'
  ``upsample_size``, which odd latent sides need) and a 3x3 conv;
  GroupNorm, SiLU and ``conv_out``. GroupNorm eps 1e-5 in the ResNets;
- the AutoencoderKL: the encoder (``conv_in``; down blocks of ResNets
  without a time embedding, each downsampling conv after a (0, 1, 0, 1)
  zero pad; a mid block with one single-head self-attention; GroupNorm,
  SiLU, ``conv_out`` to the moments) and ``quant_conv``, then the mean
  and log-variance; ``post_quant_conv`` and the decoder (the mid block,
  up blocks of ``layers_per_block + 1`` ResNets with a x2 nearest
  upsampling and a conv but on the last). GroupNorm eps 1e-6;
- the DDIM schedule: scaled-linear betas from 0.00085 to 0.012 over 1000
  steps, "leading" spacing with ``steps_offset`` 1, eta 0,
  ``set_alpha_to_one=False`` (below step 0 the previous alpha is the
  first one), over the fork's drawn range [0, T);
- IP2P's guidance: a batch of three, text states [text, empty, empty]
  against image latents [cond, cond, 0], combined as
  ε_u + g·(ε_t − ε_i) + g_i·(ε_i − ε_u);
- the fork's ``encoded-normalized`` noise: the VAE mode of the rendered
  noise image, standardised per channel (unbiased std), clipped to ±3
  with ``outlier``, used as the initial noise at the first timestep.

Attention is ``softmax(q·kᵀ/√d)·v`` over blocks of query rows, so that a
block's scores stay under ``SCORE_BYTES``: the first level of a
1557x1038 view has 25,026 tokens.

Departures: the weights are a state dict in diffusers' names, given by
the caller (the program's seeded float16 values upcast to float32, so
both sides hold the same numbers); the prompt's text states are taken as
given (the program's CLIP text tower runs once at set-up, outside the
timed path) and upcast; the edit's random draws (the strength T and the
VAE posterior's normal draw) are arguments, so the caller can replay the
program's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

SCORE_BYTES = 1 << 30
LATENT_SCALE = 0.18215

SD15_UNET = {"in_channels": 8, "out_channels": 4,
             "block_out_channels": [320, 640, 1280, 1280],
             "layers_per_block": 2, "cross_attention_dim": 768,
             "num_attention_heads": 8, "norm_groups": 32}
SD15_VAE = {"in_channels": 3, "latent_channels": 4,
            "block_out_channels": [128, 256, 512, 512],
            "layers_per_block": 2, "norm_groups": 32}


# --------------------------------------------------------------------------
# layers, over a state dict ``w``
# --------------------------------------------------------------------------

def _conv(x, w, name, stride=1, padding=1):
    return F.conv2d(x, w[name + ".weight"], w[name + ".bias"], stride,
                    padding)


def _linear(x, w, name):
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def _gn(x, w, name, groups, eps):
    return F.group_norm(x, groups, w[name + ".weight"], w[name + ".bias"],
                        eps)


def _ln(x, w, name):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], 1e-5)


def attention(q, k, v, heads: int) -> torch.Tensor:
    """(B, T, C) queries against (B, S, C) keys and values, ``heads``
    heads, in blocks of query rows → (B, T, C)."""
    B, T, C = q.shape
    S = k.shape[1]
    d = C // heads
    q = q.reshape(B, T, heads, d).transpose(1, 2)
    kt = k.reshape(B, S, heads, d).permute(0, 2, 3, 1)
    v = v.reshape(B, S, heads, d).transpose(1, 2)
    rows = max(1, min(T, SCORE_BYTES // (B * heads * S
                                         * q.element_size())))
    out = torch.empty_like(q)
    for r0 in range(0, T, rows):
        s = torch.matmul(q[:, :, r0:r0 + rows], kt) / math.sqrt(d)
        out[:, :, r0:r0 + rows] = torch.matmul(torch.softmax(s, dim=-1), v)
    return out.transpose(1, 2).reshape(B, T, C)


def _resnet(x, w, name, groups, eps, temb=None):
    h = _conv(F.silu(_gn(x, w, name + ".norm1", groups, eps)), w,
              name + ".conv1")
    if temb is not None:
        h = h + _linear(F.silu(temb), w, name + ".time_emb_proj")[
            :, :, None, None]
    h = _conv(F.silu(_gn(h, w, name + ".norm2", groups, eps)), w,
              name + ".conv2")
    if name + ".conv_shortcut.weight" in w:
        x = _conv(x, w, name + ".conv_shortcut", padding=0)
    return x + h


def _transformer(x, ctx, w, name, groups, heads):
    B, C, H, W = x.shape
    h = _conv(_gn(x, w, name + ".norm", groups, 1e-6), w, name + ".proj_in",
              padding=0)
    h = h.reshape(B, C, H * W).transpose(1, 2)
    b = name + ".transformer_blocks.0"
    n = _ln(h, w, b + ".norm1")
    h = h + _linear(attention(_linear(n, w, b + ".attn1.to_q"),
                              _linear(n, w, b + ".attn1.to_k"),
                              _linear(n, w, b + ".attn1.to_v"), heads),
                    w, b + ".attn1.to_out.0")
    n = _ln(h, w, b + ".norm2")
    h = h + _linear(attention(_linear(n, w, b + ".attn2.to_q"),
                              _linear(ctx, w, b + ".attn2.to_k"),
                              _linear(ctx, w, b + ".attn2.to_v"), heads),
                    w, b + ".attn2.to_out.0")
    n = _ln(h, w, b + ".norm3")
    a, gate = _linear(n, w, b + ".ff.net.0.proj").chunk(2, dim=-1)
    h = h + _linear(a * F.gelu(gate), w, b + ".ff.net.2")
    h = h.transpose(1, 2).reshape(B, C, H, W)
    return _conv(h, w, name + ".proj_out", padding=0) + x


# --------------------------------------------------------------------------
# the UNet
# --------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' ``Timesteps(dim, flip_sin_to_cos=True,
    downscale_freq_shift=0)``: [cos | sin] of t·10000^(−i/half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def unet(w: dict, sample: torch.Tensor, t, ctx: torch.Tensor,
         cfg: dict = SD15_UNET) -> torch.Tensor:
    """ε prediction. sample (B, in_channels, h, w), t a timestep, ctx
    (B, S, cross_attention_dim) → (B, out_channels, h, w)."""
    ch = list(cfg["block_out_channels"])
    n, L = len(ch), int(cfg["layers_per_block"])
    g, heads = int(cfg["norm_groups"]), int(cfg["num_attention_heads"])
    tt = torch.full((sample.shape[0],), float(t), device=sample.device)
    temb = _linear(F.silu(_linear(timestep_embedding(tt, ch[0]).to(
        sample.dtype), w, "time_embedding.linear_1")),
                   w, "time_embedding.linear_2")
    h = _conv(sample, w, "conv_in")
    skips = [h]
    for i in range(n):
        for j in range(L):
            h = _resnet(h, w, f"down_blocks.{i}.resnets.{j}", g, 1e-5, temb)
            if i < n - 1:
                h = _transformer(h, ctx, w, f"down_blocks.{i}.attentions.{j}",
                                 g, heads)
            skips.append(h)
        if i < n - 1:
            h = _conv(h, w, f"down_blocks.{i}.downsamplers.0.conv", stride=2)
            skips.append(h)
    h = _resnet(h, w, "mid_block.resnets.0", g, 1e-5, temb)
    h = _transformer(h, ctx, w, "mid_block.attentions.0", g, heads)
    h = _resnet(h, w, "mid_block.resnets.1", g, 1e-5, temb)
    for i in range(n):
        for j in range(L + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = _resnet(h, w, f"up_blocks.{i}.resnets.{j}", g, 1e-5, temb)
            if i > 0:
                h = _transformer(h, ctx, w, f"up_blocks.{i}.attentions.{j}",
                                 g, heads)
        if i < n - 1:
            h = F.interpolate(h, size=skips[-1].shape[-2:], mode="nearest")
            h = _conv(h, w, f"up_blocks.{i}.upsamplers.0.conv")
    h = F.silu(_gn(h, w, "conv_norm_out", g, 1e-5))
    return _conv(h, w, "conv_out")


# --------------------------------------------------------------------------
# the autoencoder
# --------------------------------------------------------------------------

def _vae_mid(x, w, name, g):
    x = _resnet(x, w, name + ".resnets.0", g, 1e-6)
    a = name + ".attentions.0"
    B, C, H, W = x.shape
    h = _gn(x, w, a + ".group_norm", g, 1e-6).reshape(B, C, H * W) \
        .transpose(1, 2)
    o = _linear(attention(_linear(h, w, a + ".to_q"),
                          _linear(h, w, a + ".to_k"),
                          _linear(h, w, a + ".to_v"), 1), w, a + ".to_out.0")
    x = x + o.transpose(1, 2).reshape(B, C, H, W)
    return _resnet(x, w, name + ".resnets.1", g, 1e-6)


def vae_moments(w: dict, img: torch.Tensor, cfg: dict = SD15_VAE):
    """img (B, 3, H, W) in [-1, 1] → (mean, logvar) of the posterior."""
    ch = list(cfg["block_out_channels"])
    n, L, g = len(ch), int(cfg["layers_per_block"]), int(cfg["norm_groups"])
    h = _conv(img, w, "encoder.conv_in")
    for i in range(n):
        for j in range(L):
            h = _resnet(h, w, f"encoder.down_blocks.{i}.resnets.{j}", g,
                        1e-6)
        if i < n - 1:
            h = _conv(F.pad(h, (0, 1, 0, 1)), w,
                      f"encoder.down_blocks.{i}.downsamplers.0.conv",
                      stride=2, padding=0)
    h = _vae_mid(h, w, "encoder.mid_block", g)
    h = _conv(F.silu(_gn(h, w, "encoder.conv_norm_out", g, 1e-6)), w,
              "encoder.conv_out")
    return _conv(h, w, "quant_conv", padding=0).chunk(2, dim=1)


def vae_decode(w: dict, lat: torch.Tensor, cfg: dict = SD15_VAE):
    """Unscaled latents (B, 4, h, w) → image (B, 3, 8h, 8w) in [-1, 1]."""
    ch = list(cfg["block_out_channels"])
    n, L, g = len(ch), int(cfg["layers_per_block"]), int(cfg["norm_groups"])
    h = _conv(_conv(lat, w, "post_quant_conv", padding=0), w,
              "decoder.conv_in")
    h = _vae_mid(h, w, "decoder.mid_block", g)
    for i in range(n):
        for j in range(L + 1):
            h = _resnet(h, w, f"decoder.up_blocks.{i}.resnets.{j}", g, 1e-6)
        if i < n - 1:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(h, w, f"decoder.up_blocks.{i}.upsamplers.0.conv")
    h = F.silu(_gn(h, w, "decoder.conv_norm_out", g, 1e-6))
    return _conv(h, w, "decoder.conv_out")


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

def alphas_cumprod(device=None) -> torch.Tensor:
    """SD's scaled-linear schedule: β = linspace(√0.00085, √0.012, 1000)²."""
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                           dtype=torch.float32, device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def timesteps(T: int, steps: int) -> list:
    """"leading" spacing over [0, T), ``steps_offset`` 1: the fork sets the
    scheduler's ``num_train_timesteps`` to its drawn T first."""
    ratio = T // steps
    return [int(i * ratio) + 1 for i in reversed(range(steps))], ratio


def ddim_step(ac, eps, t: int, ratio: int, x):
    """x_t → x_{t − ratio}, eta 0; below 0 the previous alpha is ac[0]."""
    a = ac[t]
    a_prev = ac[t - ratio] if t - ratio >= 0 else ac[0]
    x0 = (x - torch.sqrt(1 - a) * eps) / torch.sqrt(a)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps


def normalized_noise(noise: torch.Tensor, outlier: bool = True):
    """Per-channel standardisation (unbiased std), clipped to ±3."""
    mean = noise.mean(dim=(2, 3), keepdim=True)
    std = noise.std(dim=(2, 3), keepdim=True)
    out = (noise - mean) / std
    return out.clamp(-3.0, 3.0) if outlier else out


def first_input(ac, t0: int, mean, logvar, posterior_draw, cond,
                noise_mean, outlier: bool = True) -> torch.Tensor:
    """The first UNet call's input, (3, 8, h, w): the posterior sample of
    the image's moments (``mean``, ``logvar``; logvar clipped to
    [−30, 20]) scaled by 0.18215 and noised to ``t0`` with the
    normalised mode of the noise render's moments, beside the image
    latents [cond, cond, 0]."""
    lat0 = (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            * posterior_draw) * LATENT_SCALE
    a = ac[t0]
    x = torch.sqrt(a) * lat0 + torch.sqrt(1 - a) * normalized_noise(
        noise_mean, outlier)
    cond3 = torch.cat([cond, cond, torch.zeros_like(cond)], dim=0)
    return torch.cat([torch.cat([x] * 3, dim=0), cond3], dim=1)


def guide(eps: torch.Tensor, guidance: float, image_guidance: float):
    """IP2P's 3-way guidance of a batch-3 prediction [text, image,
    uncond] → (1, C, h, w)."""
    e_t, e_i, e_u = eps[0:1], eps[1:2], eps[2:3]
    return e_u + guidance * (e_t - e_i) + image_guidance * (e_i - e_u)


def edit(w_unet: dict, w_vae: dict, image, image_cond, rendered_noise,
         text: torch.Tensor, T: int, posterior_draw: torch.Tensor, *,
         guidance: float = 12.5, image_guidance: float = 1.5,
         steps: int = 20, outlier: bool = True,
         unet_cfg: dict = SD15_UNET, vae_cfg: dict = SD15_VAE,
         on_unet: Optional[Callable] = None) -> torch.Tensor:
    """One edit with the ``encoded-normalized`` noise. image, image_cond,
    rendered_noise (1, 3, H, W) in [0, 1]; text (3, S, D) the states of
    [prompt, "", ""]; T the drawn strength (in [0, 1000)); posterior_draw
    the standard normal draw of the posterior's sample, of the latents'
    shape. ``on_unet(k, x, t, ctx, eps)`` sees each UNet call. → the
    edited image (1, 3, 8h, 8w) in [0, 1]."""
    ac = alphas_cumprod(image.device)
    ts, ratio = timesteps(T, steps)
    mean, logvar = vae_moments(w_vae, image * 2 - 1, vae_cfg)
    cond = vae_moments(w_vae, image_cond * 2 - 1, vae_cfg)[0]
    noise = vae_moments(w_vae, rendered_noise * 2 - 1, vae_cfg)[0]
    inp = first_input(ac, ts[0], mean, logvar, posterior_draw, cond, noise,
                      outlier)
    x, cond3 = inp[0:1, :mean.shape[1]], inp[:, mean.shape[1]:]
    for k, t in enumerate(ts):
        inp = torch.cat([torch.cat([x] * 3, dim=0), cond3], dim=1)
        eps = unet(w_unet, inp, t, text, unet_cfg)
        if on_unet is not None:
            on_unet(k, inp, t, text, eps)
        x = ddim_step(ac, guide(eps, guidance, image_guidance), t, ratio, x)
    img = vae_decode(w_vae, x / LATENT_SCALE, vae_cfg)
    return (img / 2 + 0.5).clamp(0, 1)
