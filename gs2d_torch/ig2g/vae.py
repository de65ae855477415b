"""The Stable-Diffusion AutoencoderKL, in torch.

Counterpart of ``gs2d_tpu/ig2g/vae.py`` (the VAE boundary of the
reference editor, ip2p.py:403-504: posterior sample for the edited image,
the mode for the conditioning, latents scaled by 0.18215). Modules named
as diffusers' state dict; GroupNorm eps 1e-6 throughout; each stride-2
downsample pads (0, 1, 0, 1) first, as diffusers' VAE does, so a 540-row
image gives 68 latent rows and decodes to 544.

The autoencoder runs in the dtype of its weights (``sdnet.py`` says how
attention and the norms behave in float16): ``vae_encode_moments`` and
``vae_decode`` cast their input to it and hand back float32, which the
DDIM arithmetic on the latents keeps.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .sdnet import Block, ConvHolder, ResnetBlock, attention

SD_LATENT_SCALE = 0.18215     # reference ip2p.py:52 CONST_SCALE


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32

    @property
    def n_blocks(self):
        return len(self.block_out_channels)

    @property
    def downsample_factor(self):
        return 2 ** (self.n_blocks - 1)


SD15_VAE = VAEConfig()
TINY_VAE = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                     norm_groups=4)


class MidAttention(nn.Module):
    """Single-head spatial self-attention at the bottleneck."""

    def __init__(self, cfg: VAEConfig, c, device=None):
        super().__init__()
        self.group_norm = nn.GroupNorm(cfg.norm_groups, c, eps=1e-6,
                                       device=device)
        self.to_q = nn.Linear(c, c, device=device)
        self.to_k = nn.Linear(c, c, device=device)
        self.to_v = nn.Linear(c, c, device=device)
        self.to_out = nn.ModuleList([nn.Linear(c, c, device=device)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        o = attention(self.to_q(h), self.to_k(h), self.to_v(h), 1)
        o = self.to_out[0](o)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


def _mid_block(cfg, c, device):
    return Block([ResnetBlock(c, c, cfg.norm_groups, 1e-6, device=device)
                  for _ in range(2)], [MidAttention(cfg, c, device)])


def _mid(blk, x):
    x = blk.resnets[0](x)
    x = blk.attentions[0](x)
    return blk.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        ch, g = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1,
                                 device=device)
        blocks, c_in = [], ch[0]
        for i in range(cfg.n_blocks):
            blocks.append(Block(
                [ResnetBlock(c_in if j == 0 else ch[i], ch[i], g, 1e-6,
                             device=device)
                 for j in range(cfg.layers_per_block)],
                downsampler=ConvHolder(ch[i], 2, 0, device)
                if i < cfg.n_blocks - 1 else None))
            c_in = ch[i]
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid_block(cfg, ch[-1], device)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6, device=device)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3,
                                  padding=1, device=device)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "downsamplers"):
                # diffusers' VAE downsample: asymmetric (0,1,0,1) pad
                x = blk.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = _mid(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        g = cfg.norm_groups
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1,
                                 device=device)
        self.mid_block = _mid_block(cfg, rev[0], device)
        blocks, c_in = [], rev[0]
        for i in range(cfg.n_blocks):
            blocks.append(Block(
                [ResnetBlock(c_in if j == 0 else rev[i], rev[i], g, 1e-6,
                             device=device)
                 for j in range(cfg.layers_per_block + 1)],
                upsampler=ConvHolder(rev[i], 1, 1, device)
                if i < cfg.n_blocks - 1 else None))
            c_in = rev[i]
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6,
                                          device=device)
        self.conv_out = nn.Conv2d(rev[-1], cfg.in_channels, 3, padding=1,
                                  device=device)

    def forward(self, x):
        x = _mid(self.mid_block, self.conv_in(x))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = F.interpolate(x, scale_factor=2.0, mode="nearest")
                x = blk.upsamplers[0].conv(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """``state_dict()`` keys are diffusers' (``encoder.down_blocks.0...``,
    ``quant_conv``, ``decoder...``)."""

    def __init__(self, cfg: VAEConfig = SD15_VAE, device="cuda"):
        super().__init__()
        self.cfg = cfg
        lc = cfg.latent_channels
        self.encoder = Encoder(cfg, device)
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1, device=device)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1, device=device)
        self.decoder = Decoder(cfg, device)


def vae_encode_moments(vae: AutoencoderKL, img: torch.Tensor):
    """img (B, 3, H, W) in [-1, 1] → (mean, logvar), each (B, 4, h, w),
    float32."""
    dtype = vae.quant_conv.weight.dtype
    moments = vae.quant_conv(vae.encoder(img.to(dtype)))
    return moments.float().chunk(2, dim=1)


def vae_sample(mean, logvar, noise):
    """Reparameterised posterior sample with diffusers' logvar clip;
    ``noise`` is a standard normal draw of ``mean``'s shape."""
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return mean + std * noise


def vae_encode(vae: AutoencoderKL, img, noise=None):
    """Posterior sample (``noise`` given) or mode (None), unscaled."""
    mean, logvar = vae_encode_moments(vae, img)
    return mean if noise is None else vae_sample(mean, logvar, noise)


def vae_decode(vae: AutoencoderKL, lat: torch.Tensor) -> torch.Tensor:
    """lat (B, 4, h, w) unscaled → image (B, 3, 8h, 8w) in [-1, 1],
    float32."""
    dtype = vae.post_quant_conv.weight.dtype
    return vae.decoder(vae.post_quant_conv(lat.to(dtype))).float()


def vae_param_shapes(cfg: VAEConfig) -> dict:
    s = {}

    def conv(name, ci, co, k=3):
        s[f"{name}.weight"] = (co, ci, k, k)
        s[f"{name}.bias"] = (co,)

    def lin(name, ci, co):
        s[f"{name}.weight"] = (co, ci)
        s[f"{name}.bias"] = (co,)

    def norm(name, c):
        s[f"{name}.weight"] = (c,)
        s[f"{name}.bias"] = (c,)

    def resnet(name, ci, co):
        norm(f"{name}.norm1", ci)
        conv(f"{name}.conv1", ci, co)
        norm(f"{name}.norm2", co)
        conv(f"{name}.conv2", co, co)
        if ci != co:
            conv(f"{name}.conv_shortcut", ci, co, k=1)

    def mid(name, c):
        resnet(f"{name}.resnets.0", c, c)
        norm(f"{name}.attentions.0.group_norm", c)
        for q in ("to_q", "to_k", "to_v"):
            lin(f"{name}.attentions.0.{q}", c, c)
        lin(f"{name}.attentions.0.to_out.0", c, c)
        resnet(f"{name}.resnets.1", c, c)

    ch = cfg.block_out_channels
    conv("encoder.conv_in", cfg.in_channels, ch[0])
    c_in = ch[0]
    for i in range(cfg.n_blocks):
        name = f"encoder.down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            resnet(f"{name}.resnets.{j}", c_in if j == 0 else ch[i], ch[i])
        c_in = ch[i]
        if i < cfg.n_blocks - 1:
            conv(f"{name}.downsamplers.0.conv", ch[i], ch[i])
    mid("encoder.mid_block", ch[-1])
    norm("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", ch[-1], 2 * cfg.latent_channels)
    conv("quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)

    conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, k=1)
    conv("decoder.conv_in", cfg.latent_channels, ch[-1])
    mid("decoder.mid_block", ch[-1])
    rev = list(reversed(ch))
    c_in = rev[0]
    for i in range(cfg.n_blocks):
        name = f"decoder.up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            resnet(f"{name}.resnets.{j}", c_in if j == 0 else rev[i], rev[i])
        c_in = rev[i]
        if i < cfg.n_blocks - 1:
            conv(f"{name}.upsamplers.0.conv", rev[i], rev[i])
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], cfg.in_channels)
    return s
