"""Frequency-domain and similarity analysis of images and latents.

Counterpart of ``gs2d_tpu/ig2g/analysis.py``: radially averaged log-power
spectra, the cosine of two images' spectra, pairwise similarity matrices
(all in float64 with ``torch.fft``, on the given device), and a DDPM
ancestral sampler over the IG2G schedule with a pluggable ε-predictor and
an explicit ``torch.Generator``. ``plot_spectra`` needs matplotlib.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import numpy as np
import torch

from .ops import DDIMSchedule


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float64)


def power_spectrum_2d(x, device="cuda") -> torch.Tensor:
    """(C, H, W) or gray (H, W) → the centred log-power spectrum (H, W),
    averaged over channels."""
    x = _f64(x, device)
    if x.dim() == 2:
        x = x[None]
    f = torch.fft.fftshift(torch.fft.fft2(x), dim=(-2, -1))
    return torch.log1p(f.abs() ** 2).mean(0)


def radial_spectrum(x, n_bins: int = 64, device="cuda") -> torch.Tensor:
    """The radially averaged power spectrum profile (n_bins,): the mean of
    the log-power over each ring of radius r / r_max in [k, k+1) / n_bins
    about (H/2, W/2)."""
    ps = power_spectrum_2d(x, device)
    H, W = ps.shape
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float64, device=ps.device),
        torch.arange(W, dtype=torch.float64, device=ps.device),
        indexing="ij")
    r = torch.hypot(yy - H / 2, xx - W / 2)
    bins = torch.clamp((r / r.max() * n_bins).to(torch.int64), 0,
                       n_bins - 1).flatten()
    out = torch.zeros(n_bins, dtype=torch.float64, device=ps.device)
    out.index_add_(0, bins, ps.flatten())
    cnt = torch.bincount(bins, minlength=n_bins)
    return out / torch.clamp(cnt, min=1)


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b)
                 / (torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-12))


def spectrum_similarity(a, b, n_bins: int = 64, device="cuda") -> float:
    """The cosine similarity of two radial spectra."""
    return _cos(radial_spectrum(a, n_bins, device),
                radial_spectrum(b, n_bins, device))


def image_similarity_matrix(images: Sequence, metric: str = "l2",
                            device="cuda") -> np.ndarray:
    """Pairwise similarity grid (n, n): ``l2`` (minus the RMS difference),
    ``cosine`` of the flattened images, or ``spectrum`` (the cosine of
    their radial spectra, one spectrum per image)."""
    if metric not in ("l2", "cosine", "spectrum"):
        raise ValueError(f"unknown metric {metric!r}")
    n = len(images)
    out = np.zeros((n, n))
    if metric == "spectrum":
        xs = [radial_spectrum(im, device=device) for im in images]
    else:
        xs = [_f64(im, device) for im in images]
    for i in range(n):
        for j in range(i, n):
            a, b = xs[i], xs[j]
            if metric == "l2":
                v = -float(torch.sqrt(torch.mean((a - b) ** 2)))
            else:
                v = _cos(a.flatten(), b.flatten())
            out[i, j] = out[j, i] = v
    return out


def ddpm_sample(predict_eps, shape, generator: torch.Generator,
                num_steps: int = 50, schedule: DDIMSchedule | None = None,
                device="cuda") -> torch.Tensor:
    """Ancestral DDPM sampling with ``predict_eps(x, t)``: x_T and each
    step's noise drawn from ``generator`` (on ``device``), float32 as the
    schedule. A caller's schedule is copied, never changed."""
    sched = copy.copy(schedule) if schedule is not None \
        else DDIMSchedule(device=str(device))
    sched.set_timesteps(num_steps)
    acp = sched.alphas_cumprod.to(device)
    x = torch.randn(shape, generator=generator, device=device)
    for t in sched.timesteps:
        t = int(t)
        a_t = acp[t]
        last = t - sched.step_ratio < 0
        a_prev = torch.ones_like(a_t) if last \
            else acp[t - sched.step_ratio]
        eps = predict_eps(x, t)
        x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        sigma = torch.zeros_like(a_t) if last else torch.sqrt(
            (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
        mean = torch.sqrt(a_prev) * x0 + torch.sqrt(torch.clamp(
            1 - a_prev - sigma ** 2, min=0.0)) * eps
        noise = torch.randn(shape, generator=generator, device=device)
        x = mean + sigma * noise
    return x


def plot_spectra(images: List, labels: List[str], path: str) -> bool:
    """Radial spectra of ``images`` in one plot at ``path``; False (and
    nothing written) where matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4))
    for img, lab in zip(images, labels):
        ax.plot(radial_spectrum(img, device="cpu").numpy(), label=lab)
    ax.set_xlabel("radial frequency bin")
    ax.set_ylabel("log power")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True
