"""SSIM with an 11×11 σ=1.5 Gaussian window, and the image losses.

Counterpart of ``gs2d_tpu/ops/ssim.py`` (the reference's
``utils/loss_utils.py:37-73``: zero-padded depthwise blurs, C1 = 0.01²,
C2 = 0.03²). The window is separable; each 1-D pass is an explicit
shift-and-add over the taps in the JAX package's order, in exact float32
(a convolution would go through cuDNN, whose TF32 rounding makes
blur(x²) − mu² go negative on flat regions).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gauss_kernel(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs.astype(np.float64) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Zero-padded 1-D blur of (C, H, W) along ``axis`` (1 or 2)."""
    pad = len(taps) // 2
    n = x.shape[axis]
    xp = F.pad(x, (pad, pad) if axis == 2 else (0, 0, pad, pad))
    acc = None
    for i, k in enumerate(taps.tolist()):
        part = k * xp.narrow(axis, i, n)
        acc = part if acc is None else acc + part
    return acc


def _blur(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    return _blur_axis(_blur_axis(img, taps, 2), taps, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over a (C, H, W) image pair in [0, 1]."""
    taps = _gauss_kernel(window_size, 1.5)
    mu1 = _blur(img1, taps)
    mu2 = _blur(img2, taps)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, taps) - mu1_sq
    sigma2_sq = _blur(img2 * img2, taps) - mu2_sq
    sigma12 = _blur(img1 * img2, taps) - mu1_mu2

    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware second-order smoothness (reference loss_utils.py:28-35;
    unused by the default training loss)."""
    gdx = torch.abs(disp[:, 1:-1, :-2] + disp[:, 1:-1, 2:]
                    - 2 * disp[:, 1:-1, 1:-1])
    gdy = torch.abs(disp[:, :-2, 1:-1] + disp[:, 2:, 1:-1]
                    - 2 * disp[:, 1:-1, 1:-1])
    gix = torch.mean(torch.abs(img[:, 1:-1, :-2] - img[:, 1:-1, 2:]),
                     0, keepdim=True) * 0.5
    giy = torch.mean(torch.abs(img[:, :-2, 1:-1] - img[:, 2:, 1:-1]),
                     0, keepdim=True) * 0.5
    return torch.mean(gdx * torch.exp(-gix)) + torch.mean(gdy * torch.exp(-giy))
