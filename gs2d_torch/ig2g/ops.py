"""The diffusion-editing math, in torch.

Counterpart of ``gs2d_tpu/ig2g/ops.py`` (the reference fork's
``ip2p.py`` and its vendored diffusers UNet):

* ``fft_band``               — ip2p.py:60-82 (get_low_or_high_fft)
* ``normalize_latent_noise`` — ip2p.py:85-109
* ``DDIMSchedule``           — DDIM (eta 0), SD scaled-linear betas,
  "leading" spacing over the sampled T, ``set_alpha_to_one=False``
* ``cfg_combine`` / ``cfg_combine_rendered`` — the 3-way guidance
  (ip2p.py:356-394)
* ``fuse_skip_residuals``    — res₁·(1−λ) + res₂·λ
* ``noise_calibration``      — FFT noise calibration (ip2p.py:283-311)
* ``resize_bilinear``        — ``jax.image.resize(x, shape, "bilinear")``,
  which the JAX CLI uses to bring an edit back to the render's size
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def fft_band(x: torch.Tensor, scale: float, is_low: bool = True):
    """Keep only the low (or high) centred frequency square of half-size
    ``scale`` per spatial dim. x: (..., H, W)."""
    H, W = x.shape[-2], x.shape[-1]
    f = torch.fft.fftshift(torch.fft.fftn(x, dim=(-2, -1)), dim=(-2, -1))
    crow, ccol = H // 2, W // 2
    dr, dc = int(crow * scale), int(ccol * scale)
    mask = torch.zeros((H, W), dtype=torch.float32, device=x.device)
    mask[crow - dr:crow + dr, ccol - dc:ccol + dc] = 1.0
    if not is_low:
        mask = 1.0 - mask
    out = torch.fft.ifftn(torch.fft.ifftshift(f * mask, dim=(-2, -1)),
                          dim=(-2, -1))
    return out.real


def normalize_latent_noise(noise: torch.Tensor,
                           use_outlier_clipping: bool = False,
                           use_scaling: bool = False) -> torch.Tensor:
    """Per-channel standardisation with an optional ±3 clip and [-1, 1]
    rescale. noise: (B, C, H, W)."""
    mean = noise.mean(dim=(2, 3), keepdim=True)
    std = noise.std(dim=(2, 3), keepdim=True, correction=1)
    out = (noise - mean) / std
    if use_outlier_clipping:
        out = torch.clamp(out, -3.0, 3.0)
    if use_scaling:
        lo = out.amin(dim=(2, 3), keepdim=True)
        hi = out.amax(dim=(2, 3), keepdim=True)
        out = 2.0 * (out - lo) / (hi - lo) - 1.0
    return out


@dataclasses.dataclass
class DDIMSchedule:
    """DDIM (eta 0) with SD scaled-linear betas and leading spacing.
    ``alphas_cumprod`` is a float32 tensor on ``device``."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    steps_offset: int = 1
    device: str = "cpu"

    def __post_init__(self):
        betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                            self.num_train_timesteps) ** 2
        self.alphas_cumprod = torch.as_tensor(
            np.cumprod(1.0 - betas), dtype=torch.float32,
            device=self.device)

    def set_timesteps(self, num_inference_steps: int,
                      effective_train_timesteps: int | None = None):
        """'leading' spacing over [0, effective_train_timesteps); the fork
        shrinks the effective range to its randomly sampled T."""
        n_train = effective_train_timesteps or self.num_train_timesteps
        step_ratio = max(n_train // num_inference_steps, 1)
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
        ts = ts.astype(np.int64) + self.steps_offset
        ts = np.clip(ts, 0, self.num_train_timesteps - 1)
        self.timesteps = ts
        self.step_ratio = step_ratio
        return ts

    def add_noise(self, x0, noise, t: int):
        a = self.alphas_cumprod[int(t)]
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def step(self, noise_pred, t: int, latents):
        """One reverse DDIM step from t to t − step_ratio. Below 0 the
        previous alpha is ``alphas_cumprod[0]`` (``set_alpha_to_one=False``),
        so the last step keeps a ~sqrt(1 − a0)·ε term."""
        t = int(t)
        a_t = self.alphas_cumprod[t]
        t_prev = t - self.step_ratio
        a_prev = self.alphas_cumprod[t_prev if t_prev >= 0 else 0]
        x0_pred = (latents - torch.sqrt(1.0 - a_t) * noise_pred) \
            / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0_pred \
            + torch.sqrt(1.0 - a_prev) * noise_pred


def cfg_combine(pred_text, pred_image, pred_uncond,
                guidance_scale: float, image_guidance_scale: float):
    """The standard IP2P 3-way guidance (ip2p.py:388-393)."""
    return (pred_uncond
            + guidance_scale * (pred_text - pred_image)
            + image_guidance_scale * (pred_image - pred_uncond))


def cfg_combine_rendered(pred_text, pred_image, pred_uncond,
                         rendered_text, rendered_image, rendered_uncond,
                         guidance_scale: float,
                         image_guidance_scale: float,
                         noise_guidance_scale: float,
                         noise_guidance_scale2: float,
                         mode: str = "cfg"):
    """The fork's rendered-noise guidance variants (ip2p.py:356-386)."""
    if mode == "cfg":
        return (pred_uncond
                + guidance_scale * (pred_text - pred_image)
                + image_guidance_scale * (pred_image - pred_uncond)
                + noise_guidance_scale * (rendered_image - pred_uncond)
                + noise_guidance_scale2 * (rendered_image - pred_image))
    if mode == "cfg-simple":
        return (rendered_uncond
                + guidance_scale * (pred_text - pred_image)
                + image_guidance_scale * (pred_image - pred_uncond))
    raise ValueError(mode)


def fuse_skip_residuals(res_a, res_b, lam: float):
    """res_a·(1−λ) + res_b·λ — the vendored UNet's forward_fused blend."""
    return res_a * (1.0 - lam) + res_b * lam


def noise_calibration(latents_0: torch.Tensor, x_r: torch.Tensor,
                      e_t: torch.Tensor, schedule: DDIMSchedule,
                      t0: int, predict_eps: Callable,
                      scale: float, is_low: bool, steps: int):
    """FFT noise calibration as the reference runs it (ip2p.py:283-311):
    replace the chosen band of the implied x0 with the reference's band,
    mapping the correction back into the initial noise. The reference's
    active line feeds the clean latents to the UNet, so e_theta is the
    same in every iteration."""
    a_t = schedule.alphas_cumprod[t0 - 1]
    sqrt_a = torch.sqrt(a_t)
    sqrt_1ma = torch.sqrt(1.0 - a_t)
    for _ in range(steps):
        x = schedule.add_noise(latents_0, e_t, t0)
        e_theta = predict_eps(latents_0, t0)
        x0_t = (x - sqrt_1ma * e_theta) / sqrt_a
        e_t = e_theta + sqrt_a / sqrt_1ma * (
            fft_band(x0_t, scale, is_low) - fft_band(x_r, scale, is_low))
    return schedule.add_noise(latents_0, e_t, t0), e_t


def _triangle_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """The (n_in, n_out) weights of ``jax.image.resize``'s triangle kernel
    with antialiasing (JAX's ``compute_weight_mat``, float32): the kernel
    widens by 1/scale when it shrinks, columns are normalised, samples
    outside the input are zero."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = torch.tensor(1.0 / (n_out / n_in), **f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.0 - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, **f32)[:, None]) \
        / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, x.shape[:2] + size, "bilinear")`` for an
    (N, C, H, W) tensor: separable triangle filtering, antialiased when a
    side shrinks; a side that keeps its size is left as it is."""
    out = x
    for dim, n_out in ((2, int(size[0])), (3, int(size[1]))):
        n_in = out.shape[dim]
        if n_in == n_out:
            continue
        w = _triangle_weights(n_in, n_out, x.device)
        out = torch.movedim(torch.tensordot(out, w, dims=([dim], [0])),
                            -1, dim)
    return out
