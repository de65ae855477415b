"""CLIP-based edit metrics: the CLIP score and CLIP directional similarity.

Counterpart of ``gs2d_tpu/ig2g/metrics.py``: the CLIP score (image-text
similarity, ``logits_per_image[0, 0]``) under openai/clip-vit-base-patch16
and the directional similarity cos(unit E_img(edited) − unit E_img(original),
unit E_txt(edited caption) − unit E_txt(original caption)) under
clip-vit-large-patch14. The JAX package runs ``transformers``; the port runs
its own CLIP (``clip_model.py``), image preprocessing (``clip_image.py``)
and BPE tokenizer, reading a local snapshot in the transformers layout
(``config.json``, ``model.safetensors``, ``preprocessor_config.json``,
``vocab.json``, ``merges.txt``): the argument, else ``$GS2D_CLIP_DIR``; the
large model from its argument, else ``$GS2D_CLIP_LARGE_DIR``, else the
same snapshot.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from .clip_image import pixel_values, read_preprocessor_config
from .clip_model import load_clip
from .tokenizer import CLIPTokenizer


class _Encoder:
    """One snapshot: the model, its image preprocessing and tokenizer."""

    def __init__(self, root: str, device):
        self.device = torch.device(device)
        self.model = load_clip(root, device=self.device)
        self.image_cfg = read_preprocessor_config(root)
        # the snapshot root holds the tokenizer files in this layout
        self.tok = CLIPTokenizer.from_snapshot(
            root, self.model.cfg.text.max_positions)

    def pixels(self, img) -> torch.Tensor:
        return pixel_values(img, self.image_cfg, self.device)

    def ids(self, prompt: str) -> torch.Tensor:
        return torch.as_tensor(self.tok([prompt]), dtype=torch.int64,
                               device=self.device)


class ClipMetrics:
    def __init__(self, model_dir: Optional[str] = None,
                 large_model_dir: Optional[str] = None, device="cuda"):
        self.model = None
        self.large = None
        model_dir = model_dir or os.environ.get("GS2D_CLIP_DIR")
        large_model_dir = large_model_dir or os.environ.get(
            "GS2D_CLIP_LARGE_DIR") or model_dir
        if model_dir and os.path.isdir(model_dir):
            self.model = _Encoder(model_dir, device)
        if large_model_dir and os.path.isdir(large_model_dir):
            self.large = _Encoder(large_model_dir, device)

    def available(self) -> bool:
        return self.model is not None

    @torch.no_grad()
    def clip_score(self, image, prompt: str) -> float:
        """image (3, H, W) in [0, 1]; higher = better text alignment."""
        if not self.available():
            raise RuntimeError("ClipMetrics: no CLIP snapshot (set "
                               "GS2D_CLIP_DIR)")
        m = self.model
        return float(m.model.logits_per_image(m.pixels(image),
                                              m.ids(prompt))[0, 0])

    @torch.no_grad()
    def directional_similarity(self, img_orig, img_edit, cap_orig: str,
                               cap_edit: str) -> float:
        if self.large is None:
            raise RuntimeError("ClipMetrics: no large CLIP snapshot (set "
                               "GS2D_CLIP_LARGE_DIR or GS2D_CLIP_DIR)")

        def unit(e):
            return e / e.norm(dim=-1, keepdim=True)

        m = self.large
        img = m.model.get_image_features
        txt = m.model.get_text_features
        di = unit(img(m.pixels(img_edit))) - unit(img(m.pixels(img_orig)))
        dt = unit(txt(m.ids(cap_edit))) - unit(txt(m.ids(cap_orig)))
        return float(F.cosine_similarity(di, dt)[0])
