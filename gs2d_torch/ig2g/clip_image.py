"""CLIP's image preprocessing, without ``transformers`` or PIL.

The slow ``transformers.CLIPImageProcessor`` as ``gs2d_tpu/ig2g/
metrics.py:46-48``, ``:60-62`` feed it: a (3, H, W) image in [0, 1] becomes
``(x * 255).astype(uint8)`` (truncating), is resized so that its short side
is ``size`` (the long side ``int(size * long / short)``, as transformers'
``get_resize_output_image_size``) with PIL's bicubic filter
(``scene/images.py::resize``, bit for bit), center-cropped (top and left
``(side - crop) // 2``), rescaled (float64 times ``rescale_factor``, then
float32) and normalised ((x - mean) / std in float32). The settings come
from the snapshot's ``preprocessor_config.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..scene.images import resize

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_BICUBIC = 3                       # PIL.Image.Resampling.BICUBIC


@dataclasses.dataclass(frozen=True)
class ImageProcessorConfig:
    shortest_edge: int = 224
    crop: tuple = (224, 224)       # (height, width)
    rescale_factor: float = 1 / 255
    mean: tuple = OPENAI_CLIP_MEAN
    std: tuple = OPENAI_CLIP_STD


def read_preprocessor_config(snapshot: str) -> ImageProcessorConfig:
    """``<snapshot>/preprocessor_config.json`` (``size`` and ``crop_size``
    as ints, as old snapshots write them, or as dicts). Settings this
    module does not follow (no resize, crop, rescale or normalisation, or
    another filter) raise a ValueError naming them."""
    path = os.path.join(snapshot, "preprocessor_config.json")
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    for key in ("do_resize", "do_center_crop", "do_rescale", "do_normalize"):
        if not raw.get(key, True):
            raise ValueError(f"{path}: {key} is false; the port's CLIP "
                             "preprocessing always does it")
    if raw.get("resample", _BICUBIC) != _BICUBIC:
        raise ValueError(f"{path}: resample {raw['resample']}; the port "
                         "resizes with PIL's bicubic filter (3)")
    size = raw.get("size", 224)
    if isinstance(size, dict):
        if "shortest_edge" not in size:
            raise ValueError(f"{path}: size {size}; the port resizes the "
                             "shortest edge")
        size = size["shortest_edge"]
    crop = raw.get("crop_size", 224)
    crop = (crop["height"], crop["width"]) if isinstance(crop, dict) \
        else (crop, crop)
    return ImageProcessorConfig(
        shortest_edge=int(size), crop=tuple(int(c) for c in crop),
        rescale_factor=float(raw.get("rescale_factor", 1 / 255)),
        mean=tuple(raw.get("image_mean", OPENAI_CLIP_MEAN)),
        std=tuple(raw.get("image_std", OPENAI_CLIP_STD)))


def output_size(height: int, width: int, short: int):
    """transformers' ``get_resize_output_image_size(default_to_square=
    False)`` → (height, width)."""
    if width <= height:
        return int(short * height / width), short
    return short, int(short * width / height)


def pixel_values(image, cfg: ImageProcessorConfig,
                 device="cuda") -> torch.Tensor:
    """(3, H, W) image in [0, 1] (NumPy array or tensor, float) → float32
    ``pixel_values`` (1, 3, crop_h, crop_w) on ``device``."""
    img = torch.as_tensor(image).detach()
    u8 = (img.permute(1, 2, 0) * 255).to(torch.uint8)
    h, w = output_size(u8.shape[0], u8.shape[1], cfg.shortest_edge)
    x = torch.as_tensor(resize(u8.cpu().numpy(), w, h, device=device),
                        device=device)
    ch, cw = cfg.crop
    top, left = (h - ch) // 2, (w - cw) // 2
    if top < 0 or left < 0:
        raise ValueError(f"CLIP preprocessing: a {cw}x{ch} crop of a {w}x"
                         f"{h} image")
    x = x[top:top + ch, left:left + cw]
    x = (x.to(torch.float64) * cfg.rescale_factor).to(torch.float32)
    mean = torch.as_tensor(np.array(cfg.mean, np.float32), device=device)
    std = torch.as_tensor(np.array(cfg.std, np.float32), device=device)
    return ((x - mean) / std).permute(2, 0, 1)[None].contiguous()
