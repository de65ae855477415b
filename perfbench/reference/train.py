"""Plain PyTorch reference of one 2DGS training step, in blocks.

The loss of the 2DGS reference (``train.py`` of the paper's code):
(1 − 0.2)·L1 + 0.2·(1 − SSIM) with an 11 × 11, σ = 1.5 Gaussian window
(zero padding, C1 = 0.01², C2 = 0.03²), plus λ_normal·mean(1 − n·n_depth)
after iteration 7000 and λ_dist·mean(distortion) after 3000; Adam with
β = (0.9, 0.999), ε = 1e-15, per-group rates, the position rate decayed
log-linearly from 1.6e-4 to 1.6e-6 times the scene extent over 30,000
steps; the SH degree raised by one every 1000 iterations up to 3; the
camera order drawn without replacement from Python's ``random`` seeded
with the run's seed, a fresh stack each epoch.

The gradient is taken in three parts, so that it fits: the image
gradient of the loss by autograd on the whole image, then the per-surfel
fields' gradient block by block (``raster.composite`` with
``grad_out``), then the parameters' gradient by autograd through the
per-surfel set-up.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch
import torch.nn.functional as F

from . import raster

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15


def camera_order(seed: int, n_views: int, steps: int) -> list:
    """The training views of ``steps`` iterations: each epoch pops a
    random element of a fresh stack of all views."""
    rng = random.Random(seed)
    stack, order = [], []
    for _ in range(steps):
        if not stack:
            stack = list(range(n_views))
        order.append(stack.pop(rng.randint(0, len(stack) - 1)))
    return order


def position_lr(iteration: int, extent: float, opt: dict) -> float:
    t = min(max(iteration / opt["position_lr_max_steps"], 0.0), 1.0)
    lo = math.log(opt["position_lr_init"] * extent)
    hi = math.log(opt["position_lr_final"] * extent)
    return math.exp(lo * (1 - t) + hi * t)


def learning_rates(iteration: int, extent: float, opt: dict) -> dict:
    return {"xyz": position_lr(iteration, extent, opt),
            "features_dc": opt["feature_lr"],
            "features_rest": opt["feature_lr"] / 20.0,
            "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"],
            "opacity": opt["opacity_lr"]}


def _window(dtype, device) -> torch.Tensor:
    x = np.arange(11) - 5
    g = np.exp(-(x.astype(np.float64) ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    return torch.as_tensor(np.outer(g, g), dtype=dtype, device=device)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images."""
    w = _window(a.dtype, a.device)[None, None].expand(3, 1, 11, 11)

    def blur(x):
        return F.conv2d(x[None], w, padding=5, groups=3)[0]

    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def loss_of(out: dict, gt: torch.Tensor, iteration: int, opt: dict):
    img = out["render"]
    l1 = torch.mean(torch.abs(img - gt))
    base = (1 - opt["lambda_dssim"]) * l1 \
        + opt["lambda_dssim"] * (1 - ssim(img, gt))
    lam_n = opt["lambda_normal"] if iteration > 7000 else 0.0
    lam_d = opt["lambda_dist"] if iteration > 3000 else 0.0
    normal = 1 - torch.sum(out["rend_normal"] * out["surf_normal"], 0)
    return base + lam_n * normal.mean() + lam_d * out["rend_dist"].mean()


def gradient(params: dict, view: raster.View, gt: torch.Tensor,
             iteration: int, opt: dict, bg: torch.Tensor, *,
             depth_ratio: float = 0.0, block: int = 1 << 26):
    """(loss, {field: gradient}) of one step at ``params``, the surface
    depth mixed from the expected and median depths by ``depth_ratio``."""
    dev = params["xyz"].device
    leaves = {f: params[f].detach().requires_grad_() for f in FIELDS}
    mats = raster.matrices(view, dev, params["xyz"].dtype)
    W, H = view.width, view.height
    with torch.enable_grad():
        s = raster.setup(leaves, mats, W, H)
    fields = s.fields.detach().requires_grad_()
    cells = raster.cell_lists(s, W, H)
    ch = raster.composite(fields.detach(), cells, W, H, block=block)
    ch.requires_grad_()
    with torch.enable_grad():
        loss = loss_of(raster.bridge(ch, mats, W, H, bg, depth_ratio), gt,
                       iteration, opt)
        (g_ch,) = torch.autograd.grad(loss, ch)
    raster.composite(fields, cells, W, H, grad_out=g_ch, block=block)
    torch.autograd.backward(s.fields, fields.grad)
    return loss.detach(), {f: leaves[f].grad for f in FIELDS}


def adam(params: dict, grads: dict, mu: dict, nu: dict, step: int,
         lrs: dict):
    """One Adam update → (params, mu, nu), ``step`` counting this one."""
    c1 = 1 - BETA1 ** step
    c2 = 1 - BETA2 ** step
    p2, m2, v2 = {}, {}, {}
    for f in FIELDS:
        m = BETA1 * mu[f] + (1 - BETA1) * grads[f]
        v = BETA2 * nu[f] + (1 - BETA2) * grads[f] * grads[f]
        p2[f] = params[f] - lrs[f] * (m / c1) / (torch.sqrt(v / c2) + EPS)
        m2[f], v2[f] = m, v
    return p2, m2, v2
