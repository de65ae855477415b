"""The Stable-Diffusion UNet2DCondition (InstructPix2Pix), in torch.

Counterpart of ``gs2d_tpu/ig2g/sdnet.py``: the UNet the reference fork
drives (timbrooks/instruct-pix2pix, SD-1.5 with 8 input channels), with the
fork's two extra entry points — ``forward_intermediate`` (the down path's
skip stack) and ``forward_fused`` (a full pass whose skips are blended
``own·(1−λ) + other·λ``) — and FreeU's backbone and skip scaling.

The network is built of ``nn.Module``s whose ``state_dict()`` keys are the
diffusers names (``down_blocks.0.attentions.0...``) that the JAX package's
flat dict uses, so a diffusers checkpoint and the JAX params both load by
name (``sd_weights.py``). Two departures from the JAX forward, both what
diffusers does:

* every up block upsamples to the size of the skip it meets next
  (``F.interpolate(size=..., mode="nearest")``), so latent sides that are
  not a multiple of 2^(n_blocks−1) work; the JAX UNet always doubles, and
  its concatenation fails there;
* attention is ``scaled_dot_product_attention`` (diffusers'
  ``AttnProcessor2_0``), whose fused kernels never hold the score tensor
  (a 1557×1038 view has 25,026 tokens at the first level) and in half
  precision keep the scores and the softmax in float32, so they do not
  overflow.

The network runs in the dtype of its weights, as diffusers'
``from_pretrained(torch_dtype=...)`` does: the sample and the text states
are cast to it on entry, the sinusoidal timestep embedding is computed in
float32 and cast, and FreeU's Fourier filter runs in float32. GroupNorm
and LayerNorm take their statistics in float32 in every dtype (PyTorch's
kernels accumulate in float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-1.5 / InstructPix2Pix UNet2DCondition hyperparameters."""
    in_channels: int = 8            # 4 latent + 4 image-cond (IP2P concat)
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_attention_heads: int = 8
    norm_groups: int = 32

    @property
    def n_blocks(self):
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self):
        return self.block_out_channels[0] * 4


SD15_IP2P_UNET = UNetConfig()
TINY_UNET = UNetConfig(block_out_channels=(8, 16), layers_per_block=1,
                       cross_attention_dim=16, num_attention_heads=2,
                       norm_groups=4)


@dataclasses.dataclass(frozen=True)
class FreeUParams:
    """FreeU backbone/skip scaling (arXiv 2309.11497; the reference sets it
    with pipe.enable_freeu(s1, s2, b1, b2), ip2p.py:167-168)."""
    s1: float = 0.9
    s2: float = 0.2
    b1: float = 1.2
    b2: float = 1.4


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def attention(q, k, v, heads: int, mask=None, scale=None) -> torch.Tensor:
    """softmax(q·kᵀ/scale + mask)·v per head, scale √dh by default.
    q: (B, T, C); k, v: (B, S, C) → (B, T, C)."""
    B, T, C = q.shape
    S = k.shape[1]
    dh = C // heads
    scale = math.sqrt(dh) if scale is None else scale
    q = q.reshape(B, T, heads, dh).transpose(1, 2)
    k = k.reshape(B, S, heads, dh).transpose(1, 2)
    v = v.reshape(B, S, heads, dh).transpose(1, 2)
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=None if mask is None else mask.to(q.dtype),
        scale=1.0 / scale)
    return out.transpose(1, 2).reshape(B, T, C)


class Attention(nn.Module):
    def __init__(self, dim, ctx_dim, heads, device=None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False, device=device)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False, device=device)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False, device=device)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim, device=device)])

    def forward(self, x, ctx):
        o = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                      self.heads)
        return self.to_out[0](o)


class GEGLU(nn.Module):
    def __init__(self, dim, hidden, device=None):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * hidden, device=device)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, device=None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim, device), nn.Identity(),
                                  nn.Linear(4 * dim, dim, device=device)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim, ctx_dim, heads, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn1 = Attention(dim, dim, heads, device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn2 = Attention(dim, ctx_dim, heads, device)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.ff = FeedForward(dim, device)

    def forward(self, x, ctx):
        h = self.norm1(x)
        x = x + self.attn1(h, h)
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GN → 1x1 conv in → block → 1x1 conv out + res."""

    def __init__(self, cfg: UNetConfig, c, device=None):
        super().__init__()
        self.norm = nn.GroupNorm(cfg.norm_groups, c, eps=1e-6, device=device)
        self.proj_in = nn.Conv2d(c, c, 1, device=device)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(
            c, cfg.cross_attention_dim, cfg.num_attention_heads, device)])
        self.proj_out = nn.Conv2d(c, c, 1, device=device)

    def forward(self, x, ctx):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(B, C, H * W).transpose(1, 2)
        h = self.transformer_blocks[0](h, ctx)
        h = h.transpose(1, 2).reshape(B, C, H, W)
        return self.proj_out(h) + x


class ResnetBlock(nn.Module):
    """GN → SiLU → conv (+ time embedding) → GN → SiLU → conv, plus the
    input (through a 1x1 conv where the widths differ)."""

    def __init__(self, ci, co, groups, eps, temb_dim=None, device=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, ci, eps=eps, device=device)
        self.conv1 = nn.Conv2d(ci, co, 3, padding=1, device=device)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, co, device=device)
        self.norm2 = nn.GroupNorm(groups, co, eps=eps, device=device)
        self.conv2 = nn.Conv2d(co, co, 3, padding=1, device=device)
        if ci != co:
            self.conv_shortcut = nn.Conv2d(ci, co, 1, device=device)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class ConvHolder(nn.Module):
    """A module that holds one ``conv`` (diffusers' Downsample2D and
    Upsample2D, named ``downsamplers.0.conv`` / ``upsamplers.0.conv``)."""

    def __init__(self, c, stride, padding, device=None):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=stride, padding=padding,
                              device=device)


class Block(nn.Module):
    """One level of the UNet (or the VAE): resnets, optional attentions,
    an optional down- or upsampler."""

    def __init__(self, resnets, attentions=(), downsampler=None,
                 upsampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsampler is not None:
            self.downsamplers = nn.ModuleList([downsampler])
        if upsampler is not None:
            self.upsamplers = nn.ModuleList([upsampler])


class TimeEmbedding(nn.Module):
    def __init__(self, ci, co, device=None):
        super().__init__()
        self.linear_1 = nn.Linear(ci, co, device=device)
        self.linear_2 = nn.Linear(co, co, device=device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal embedding, diffusers' SD convention (freq_shift 0,
    flip_sin_to_cos → [cos | sin])."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _fourier_filter(x, threshold, scale):
    """FreeU skip filtering: scale the centred low-frequency
    (2·threshold)² box of the 2-D spectrum by ``scale``, in float32 (as
    diffusers' ``fourier_filter``; cuFFT takes half precision at sides of
    powers of two only) and back to ``x``'s dtype."""
    B, C, H, W = x.shape
    dtype, x = x.dtype, x.float()
    f = torch.fft.fftshift(torch.fft.fft2(x), dim=(-2, -1))
    crow, ccol = H // 2, W // 2
    mask = torch.ones((H, W), dtype=torch.float32, device=x.device)
    mask[crow - threshold:crow + threshold,
         ccol - threshold:ccol + threshold] = scale
    return torch.fft.ifft2(torch.fft.ifftshift(
        f * mask, dim=(-2, -1))).real.to(dtype)


def _apply_freeu(freeu: Optional[FreeUParams], stage, h, skip):
    """diffusers apply_freeu: at up stages 0 and 1 scale the first half of
    the backbone channels by b1/b2 and low-pass-scale the skip by s1/s2."""
    if freeu is None or stage > 1:
        return h, skip
    b = freeu.b1 if stage == 0 else freeu.b2
    s = freeu.s1 if stage == 0 else freeu.s2
    half = h.shape[1] // 2
    h = torch.cat([h[:, :half] * b, h[:, half:]], dim=1)
    return h, _fourier_filter(skip, 1, s)


# --------------------------------------------------------------------------
# the UNet
# --------------------------------------------------------------------------

class UNet2DCondition(nn.Module):
    """The eps-predicting UNet; ``state_dict()`` keys are diffusers'.
    ``device="meta"`` builds it without memory, to load weights into with
    ``load_state_dict(..., assign=True)``."""

    def __init__(self, cfg: UNetConfig = SD15_IP2P_UNET, device="cuda"):
        super().__init__()
        self.cfg = cfg
        ch, g, temb = cfg.block_out_channels, cfg.norm_groups, \
            cfg.time_embed_dim
        n = cfg.n_blocks
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1,
                                 device=device)
        self.time_embedding = TimeEmbedding(ch[0], temb, device)
        down, c_in = [], ch[0]
        for i in range(n):
            has_attn = i < n - 1
            down.append(Block(
                [ResnetBlock(c_in if j == 0 else ch[i], ch[i], g, 1e-5, temb,
                             device) for j in range(cfg.layers_per_block)],
                [SpatialTransformer(cfg, ch[i], device)
                 for _ in range(cfg.layers_per_block)] if has_attn else (),
                downsampler=ConvHolder(ch[i], 2, 1, device)
                if i < n - 1 else None))
            c_in = ch[i]
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Block(
            [ResnetBlock(ch[-1], ch[-1], g, 1e-5, temb, device)
             for _ in range(2)], [SpatialTransformer(cfg, ch[-1], device)])
        rev = list(reversed(ch))
        up, out_c = [], rev[0]
        for i in range(n):
            prev_c, out_c = out_c, rev[i]
            in_c = rev[min(i + 1, n - 1)]
            nres = cfg.layers_per_block + 1
            resnets = []
            for j in range(nres):
                skip_c = in_c if j == nres - 1 else out_c
                resnets.append(ResnetBlock(
                    (prev_c if j == 0 else out_c) + skip_c, out_c, g, 1e-5,
                    temb, device))
            up.append(Block(
                resnets,
                [SpatialTransformer(cfg, out_c, device)
                 for _ in range(nres)] if i != 0 else (),
                upsampler=ConvHolder(out_c, 1, 1, device)
                if i < n - 1 else None))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=1e-5, device=device)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1,
                                  device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def _time_embed(self, t, batch, device):
        t = torch.as_tensor(t, dtype=torch.float32, device=device)
        t = torch.broadcast_to(t, (batch,))
        return self.time_embedding(timestep_embedding(
            t, self.cfg.block_out_channels[0]).to(self.dtype))

    def _down_path(self, sample, temb, ctx):
        """conv_in + down blocks → (bottom sample, skip stack)."""
        sample = self.conv_in(sample)
        skips = [sample]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                sample = res(sample, temb)
                if len(blk.attentions):
                    sample = blk.attentions[j](sample, ctx)
                skips.append(sample)
            if hasattr(blk, "downsamplers"):
                sample = blk.downsamplers[0].conv(sample)
                skips.append(sample)
        return sample, skips

    def _mid(self, sample, temb, ctx):
        m = self.mid_block
        sample = m.resnets[0](sample, temb)
        sample = m.attentions[0](sample, ctx)
        return m.resnets[1](sample, temb)

    def _up_path(self, sample, skips, temb, ctx, skips2=None, lam=0.0,
                 freeu=None):
        """Up blocks consuming the skip stack; an optional second stack is
        blended ``skip·(1−λ) + skip2·λ`` (the fork's forward_fused)."""
        skips = list(skips)
        skips2 = None if skips2 is None else list(skips2)
        for i, blk in enumerate(self.up_blocks):
            for j, res in enumerate(blk.resnets):
                skip = skips.pop()
                if skips2 is not None:
                    skip = skip * (1.0 - lam) + skips2.pop() * lam
                sample, skip = _apply_freeu(freeu, i, sample, skip)
                sample = res(torch.cat([sample, skip], dim=1), temb)
                if len(blk.attentions):
                    sample = blk.attentions[j](sample, ctx)
            if hasattr(blk, "upsamplers"):
                # to the size of the skip met next, as diffusers does
                sample = F.interpolate(sample, size=skips[-1].shape[-2:],
                                       mode="nearest")
                sample = blk.upsamplers[0].conv(sample)
        return sample

    def _out(self, sample):
        return self.conv_out(F.silu(self.conv_norm_out(sample)))

    def forward(self, sample, t, ctx, freeu: Optional[FreeUParams] = None):
        """Eps prediction in the weights' dtype. sample: (B, in_ch, H, W);
        ctx: (B, S, D)."""
        sample, ctx = sample.to(self.dtype), ctx.to(self.dtype)
        temb = self._time_embed(t, sample.shape[0], sample.device)
        sample, skips = self._down_path(sample, temb, ctx)
        sample = self._mid(sample, temb, ctx)
        return self._out(self._up_path(sample, skips, temb, ctx,
                                       freeu=freeu))

    def intermediate(self, sample, t, ctx):
        """The fork's forward_intermediate: the down path's skip stack."""
        sample, ctx = sample.to(self.dtype), ctx.to(self.dtype)
        temb = self._time_embed(t, sample.shape[0], sample.device)
        return self._down_path(sample, temb, ctx)[1]

    def fused(self, sample, skips2, lam, t, ctx,
              freeu: Optional[FreeUParams] = None):
        """The fork's forward_fused: a full pass whose up-path skips are
        ``own·(1−λ) + skips2·λ``."""
        sample, ctx = sample.to(self.dtype), ctx.to(self.dtype)
        temb = self._time_embed(t, sample.shape[0], sample.device)
        sample, skips = self._down_path(sample, temb, ctx)
        sample = self._mid(sample, temb, ctx)
        return self._out(self._up_path(sample, skips, temb, ctx,
                                       skips2=skips2, lam=lam, freeu=freeu))


def unet_apply(unet: UNet2DCondition, sample, t, ctx,
               freeu: Optional[FreeUParams] = None) -> torch.Tensor:
    """Full eps prediction (``gs2d_tpu`` ``unet_apply``)."""
    return unet(sample, t, ctx, freeu=freeu)


def unet_apply_intermediate(unet: UNet2DCondition, sample, t, ctx) -> list:
    """The down path's skip stack (``unet_apply_intermediate``)."""
    return unet.intermediate(sample, t, ctx)


def unet_apply_fused(unet: UNet2DCondition, sample, skips2, lam, t, ctx,
                     freeu: Optional[FreeUParams] = None) -> torch.Tensor:
    """A full pass with blended skips (``unet_apply_fused``)."""
    return unet.fused(sample, skips2, lam, t, ctx, freeu=freeu)


# --------------------------------------------------------------------------
# the parameter spec (a checkpoint is checked against it) and random init
# --------------------------------------------------------------------------

def unet_param_shapes(cfg: UNetConfig) -> dict:
    s = {}

    def conv(name, ci, co, k=3):
        s[f"{name}.weight"] = (co, ci, k, k)
        s[f"{name}.bias"] = (co,)

    def lin(name, ci, co, bias=True):
        s[f"{name}.weight"] = (co, ci)
        if bias:
            s[f"{name}.bias"] = (co,)

    def norm(name, c):
        s[f"{name}.weight"] = (c,)
        s[f"{name}.bias"] = (c,)

    def resnet(name, ci, co):
        norm(f"{name}.norm1", ci)
        conv(f"{name}.conv1", ci, co)
        lin(f"{name}.time_emb_proj", cfg.time_embed_dim, co)
        norm(f"{name}.norm2", co)
        conv(f"{name}.conv2", co, co)
        if ci != co:
            conv(f"{name}.conv_shortcut", ci, co, k=1)

    def xformer(name, c):
        norm(f"{name}.norm", c)
        conv(f"{name}.proj_in", c, c, k=1)
        tb = f"{name}.transformer_blocks.0"
        for ln in ("norm1", "norm2", "norm3"):
            norm(f"{tb}.{ln}", c)
        lin(f"{tb}.attn1.to_q", c, c, bias=False)
        lin(f"{tb}.attn1.to_k", c, c, bias=False)
        lin(f"{tb}.attn1.to_v", c, c, bias=False)
        lin(f"{tb}.attn1.to_out.0", c, c)
        lin(f"{tb}.attn2.to_q", c, c, bias=False)
        lin(f"{tb}.attn2.to_k", cfg.cross_attention_dim, c, bias=False)
        lin(f"{tb}.attn2.to_v", cfg.cross_attention_dim, c, bias=False)
        lin(f"{tb}.attn2.to_out.0", c, c)
        lin(f"{tb}.ff.net.0.proj", c, 8 * c)
        lin(f"{tb}.ff.net.2", 4 * c, c)
        conv(f"{name}.proj_out", c, c, k=1)

    ch = cfg.block_out_channels
    conv("conv_in", cfg.in_channels, ch[0])
    lin("time_embedding.linear_1", ch[0], cfg.time_embed_dim)
    lin("time_embedding.linear_2", cfg.time_embed_dim, cfg.time_embed_dim)

    c_in = ch[0]
    for i in range(cfg.n_blocks):
        name = f"down_blocks.{i}"
        has_attn = i < cfg.n_blocks - 1
        for j in range(cfg.layers_per_block):
            resnet(f"{name}.resnets.{j}", c_in if j == 0 else ch[i], ch[i])
            if has_attn:
                xformer(f"{name}.attentions.{j}", ch[i])
        c_in = ch[i]
        if i < cfg.n_blocks - 1:
            conv(f"{name}.downsamplers.0.conv", ch[i], ch[i])

    resnet("mid_block.resnets.0", ch[-1], ch[-1])
    xformer("mid_block.attentions.0", ch[-1])
    resnet("mid_block.resnets.1", ch[-1], ch[-1])

    rev = list(reversed(ch))
    out_c = rev[0]
    for i in range(cfg.n_blocks):
        name = f"up_blocks.{i}"
        prev_c = out_c
        out_c = rev[i]
        in_c = rev[min(i + 1, cfg.n_blocks - 1)]
        has_attn = i != 0
        for j in range(cfg.layers_per_block + 1):
            skip_c = in_c if j == cfg.layers_per_block else out_c
            res_in = (prev_c if j == 0 else out_c) + skip_c
            resnet(f"{name}.resnets.{j}", res_in, out_c)
            if has_attn:
                xformer(f"{name}.attentions.{j}", out_c)
        if i < cfg.n_blocks - 1:
            conv(f"{name}.upsamplers.0.conv", out_c, out_c)

    norm("conv_norm_out", ch[0])
    conv("conv_out", ch[0], cfg.out_channels)
    return s


def init_params(shapes: dict, generator: torch.Generator, scale=0.1,
                device="cuda", dtype=torch.float32) -> dict:
    """Random params at the JAX ``init_params``' scaling: zero biases,
    unit 1-D weights, other weights normal · scale / √fan_in; drawn from
    ``generator`` (on ``device``) in sorted-name order."""
    p = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            p[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif len(shape) == 1:
            p[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan_in = shape[1] if len(shape) == 2 else math.prod(shape[1:])
            w = torch.randn(shape, generator=generator, device=device)
            p[name] = (w * (scale / math.sqrt(max(1, fan_in)))).to(dtype)
    return p
