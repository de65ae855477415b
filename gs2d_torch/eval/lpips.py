"""LPIPS perceptual metric (VGG16 backbone) in torch.

Counterpart of ``gs2d_tpu/eval/lpips.py:26-92`` (the reference's vendored
lpipsPyTorch): VGG16 features after convs 1, 3, 6, 9 and 12 (relu1_2 to
relu5_3) of the z-scored [0, 1] image (the vendored code's shift and
scale, without upstream LPIPS's [-1, 1] remap), each normalised along
channels as ``x / (‖x‖ + 1e-10)``, squared differences weighted by the 1x1
linear heads, averaged over space and summed over the five taps.

Weights load from the same local npz the JAX package reads
(``GS2D_LPIPS_WEIGHTS`` or the ``weights_path`` argument): ``conv{i}_w``,
``conv{i}_b`` for the 13 convolutions and ``lin{j}`` for the 5 heads, as
``scripts/convert_lpips_weights.py`` writes them. Nothing is downloaded:
without the file ``available()`` is false and callers report LPIPS as
null.

The convolutions are ``F.conv2d`` (the JAX package's are
``lax.conv_general_dilated``, outside any Pallas kernel). On a card they
run in full FP32: cuDNN takes TF32 for convolutions by default
(``torch.backends.cudnn.allow_tf32``), which moves LPIPS by ~1e-3
relative. ``import gs2d_torch`` turns the flag off for the whole program;
``forward`` also turns it off for its own convolutions, whatever a caller
set since, and restores it after.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: (out_channels, pool_before)
VGG_PLAN = [(64, False), (64, False), (128, True), (128, False),
            (256, True), (256, False), (256, False), (512, True),
            (512, False), (512, False), (512, True), (512, False),
            (512, False)]
# indices (into the conv list) after whose relu the features are tapped
TAPS = [1, 3, 6, 9, 12]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions without TF32 inside the block; the flag is
    restored after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class LPIPS(torch.nn.Module):
    def __init__(self, weights_path: Optional[str] = None, device="cuda"):
        super().__init__()
        weights_path = weights_path or os.environ.get("GS2D_LPIPS_WEIGHTS")
        self.loaded = bool(weights_path and os.path.exists(weights_path))
        if not self.loaded:
            return
        z = np.load(weights_path)
        dev = torch.device(device)
        for k in z.files:
            self.register_buffer(k, torch.as_tensor(
                np.asarray(z[k], np.float32), device=dev))

    def available(self) -> bool:
        return self.loaded

    def _features(self, img: torch.Tensor):
        shift = torch.tensor(_SHIFT, device=img.device).view(3, 1, 1)
        scale = torch.tensor(_SCALE, device=img.device).view(3, 1, 1)
        h = ((img - shift) / scale)[None]                # (1, 3, H, W)
        taps = []
        for i, (_, pool) in enumerate(VGG_PLAN):
            if pool:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(F.conv2d(h, getattr(self, f"conv{i}_w"),
                                getattr(self, f"conv{i}_b"), padding=1))
            if i in TAPS:
                taps.append(h)
        return taps

    @torch.no_grad()
    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (3, H, W) in [0, 1] → scalar LPIPS distance."""
        if not self.loaded:
            raise RuntimeError("LPIPS weights not loaded: set "
                               "GS2D_LPIPS_WEIGHTS to the npz of "
                               "scripts/convert_lpips_weights.py")
        with fp32_convolutions():
            fx, fy = self._features(x), self._features(y)
        total = torch.zeros((), device=x.device)
        for j, (a, b) in enumerate(zip(fx, fy)):
            na = a / (torch.sqrt(torch.sum(a * a, 1, keepdim=True)) + 1e-10)
            nb = b / (torch.sqrt(torch.sum(b * b, 1, keepdim=True)) + 1e-10)
            lin = getattr(self, f"lin{j}").view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((na - nb) ** 2 * lin, 1))
        return total
