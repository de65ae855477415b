"""The CLIP dual encoder (image and text towers with their projections), in
torch, for the IG2G edit metrics.

Counterpart of the ``transformers.CLIPModel`` that
``gs2d_tpu/ig2g/metrics.py`` loads (openai/clip-vit-base-patch16 for the
CLIP score, openai/clip-vit-large-patch14 for directional similarity).
Modules are named as the ``transformers`` state dict, so a snapshot's
``model.safetensors`` loads by name through the port's safetensors reader
(the ``*.position_ids`` buffers older snapshots carry are not parameters
here and are ignored):

- vision tower: ``vision_model.embeddings.{patch_embedding (Conv2d, no
  bias), class_embedding, position_embedding}``, ``pre_layrnorm`` (sic),
  pre-LN layers with quick-GELU (``clip_text._Layer``, no mask), then
  ``post_layernorm`` on the class token;
- text tower: ``clip_text``'s tower, pooled at the end-of-text token;
- ``visual_projection`` and ``text_projection`` (no bias), ``logit_scale``.

Pooling copies transformers 4.57's ``CLIPTextTransformer``: a config whose
``eos_token_id`` is 2 (the openai snapshots' legacy value) pools at
``argmax(input_ids)``, any other at the first position of
``eos_token_id``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import torch
from torch import nn

from .clip_text import CLIPTextConfig, _Encoder, _TextModel, clip_param_shapes


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    patch: int = 16
    image_size: int = 224


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    text: CLIPTextConfig
    vision: CLIPVisionConfig
    projection: int
    eos_token_id: int = 2


CLIP_VIT_B16 = CLIPConfig(
    text=CLIPTextConfig(hidden=512, layers=12, heads=8),
    vision=CLIPVisionConfig(hidden=768, layers=12, heads=12, patch=16),
    projection=512)
CLIP_VIT_L14 = CLIPConfig(
    text=CLIPTextConfig(hidden=768, layers=12, heads=12),
    vision=CLIPVisionConfig(hidden=1024, layers=24, heads=16, patch=14),
    projection=768)
TINY = CLIPConfig(
    text=CLIPTextConfig(vocab_size=600, hidden=32, layers=2, heads=4,
                        max_positions=16),
    vision=CLIPVisionConfig(hidden=32, layers=2, heads=4, patch=8,
                            image_size=32),
    projection=24)

# transformers' CLIPTextConfig / CLIPVisionConfig defaults, which a
# config.json leaves out where a snapshot keeps them
_TEXT_DEFAULTS = {"vocab_size": 49408, "hidden_size": 512,
                  "intermediate_size": 2048, "num_hidden_layers": 12,
                  "num_attention_heads": 8, "max_position_embeddings": 77,
                  "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5,
                  "eos_token_id": 49407}
_VISION_DEFAULTS = {"hidden_size": 768, "intermediate_size": 3072,
                    "num_hidden_layers": 12, "num_attention_heads": 12,
                    "num_channels": 3, "image_size": 224, "patch_size": 32,
                    "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5}


def read_config(snapshot: str) -> CLIPConfig:
    """The ``CLIPConfig`` of ``<snapshot>/config.json``; a tower this
    module cannot build (another activation, MLP width, LayerNorm epsilon
    or channel count) raises a ValueError naming the field."""
    path = os.path.join(snapshot, "config.json")
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    t = {**_TEXT_DEFAULTS, **raw.get("text_config", {})}
    v = {**_VISION_DEFAULTS, **raw.get("vision_config", {})}
    for name, c in (("text_config", t), ("vision_config", v)):
        for key, want in (("hidden_act", "quick_gelu"),
                          ("intermediate_size", 4 * c["hidden_size"]),
                          ("layer_norm_eps", 1e-5)):
            if c[key] != want:
                raise ValueError(f"{path}: {name}.{key} is {c[key]!r}; the "
                                 f"port's CLIP builds {want!r}")
    if v["num_channels"] != 3:
        raise ValueError(f"{path}: vision_config.num_channels is "
                         f"{v['num_channels']}; the port's CLIP takes RGB")
    return CLIPConfig(
        text=CLIPTextConfig(vocab_size=t["vocab_size"],
                            hidden=t["hidden_size"],
                            layers=t["num_hidden_layers"],
                            heads=t["num_attention_heads"],
                            max_positions=t["max_position_embeddings"]),
        vision=CLIPVisionConfig(hidden=v["hidden_size"],
                                layers=v["num_hidden_layers"],
                                heads=v["num_attention_heads"],
                                patch=v["patch_size"],
                                image_size=v["image_size"]),
        projection=raw.get("projection_dim", 512),
        eos_token_id=t["eos_token_id"])


def _positions(cfg: CLIPVisionConfig) -> int:
    return (cfg.image_size // cfg.patch) ** 2 + 1


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden,
                                                        device=device))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden, cfg.patch,
                                         stride=cfg.patch, bias=False,
                                         device=device)
        self.position_embedding = nn.Embedding(_positions(cfg), cfg.hidden,
                                               device=device)


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg, device)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden, eps=1e-5, device=device)
        self.encoder = _Encoder(cfg, device)
        self.post_layernorm = nn.LayerNorm(cfg.hidden, eps=1e-5,
                                           device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, 3, S, S) → the pooled class token (B, hidden)."""
        e = self.embeddings
        x = e.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = e.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + e.position_embedding.weight
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x, None)
        return self.post_layernorm(x[:, 0])


class CLIPModel(nn.Module):
    def __init__(self, cfg: CLIPConfig = CLIP_VIT_B16, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg.text, device)
        self.vision_model = _VisionModel(cfg.vision, device)
        self.visual_projection = nn.Linear(cfg.vision.hidden, cfg.projection,
                                           bias=False, device=device)
        self.text_projection = nn.Linear(cfg.text.hidden, cfg.projection,
                                         bias=False, device=device)
        self.logit_scale = nn.Parameter(torch.empty((), device=device))

    def get_image_features(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, 3, S, S) → image embeddings (B, projection)."""
        return self.visual_projection(self.vision_model(pixels))

    def get_text_features(self, ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, T) → text embeddings (B, projection), pooled by
        the config's rule (module docstring)."""
        hidden = self.text_model(ids)
        ids32 = ids.to(torch.int32)
        if self.cfg.eos_token_id == 2:
            pos = ids32.argmax(-1)
        else:
            pos = (ids32 == self.cfg.eos_token_id).to(torch.int32).argmax(-1)
        pooled = hidden[torch.arange(ids.shape[0], device=ids.device), pos]
        return self.text_projection(pooled)

    def logits_per_image(self, pixels: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
        """exp(logit_scale) · the cosines of every image with every text
        (B_img, B_txt)."""
        img = self.get_image_features(pixels)
        txt = self.get_text_features(ids)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return (txt @ img.t() * self.logit_scale.exp()).t()


def clip_model_param_shapes(cfg: CLIPConfig) -> dict:
    """Every parameter of ``CLIPModel(cfg)`` by its transformers name."""
    s = clip_param_shapes(cfg.text)
    v = cfg.vision
    pre = "vision_model"
    s[f"{pre}.embeddings.class_embedding"] = (v.hidden,)
    s[f"{pre}.embeddings.patch_embedding.weight"] = (v.hidden, 3, v.patch,
                                                     v.patch)
    s[f"{pre}.embeddings.position_embedding.weight"] = (_positions(v),
                                                        v.hidden)
    for name in ("pre_layrnorm", "post_layernorm"):
        s[f"{pre}.{name}.weight"] = s[f"{pre}.{name}.bias"] = (v.hidden,)
    for k, shape in clip_param_shapes(
            CLIPTextConfig(vocab_size=1, hidden=v.hidden, layers=v.layers,
                           heads=v.heads, max_positions=1)).items():
        if ".encoder." in k:
            s[k.replace("text_model.", f"{pre}.", 1)] = shape
    s["visual_projection.weight"] = (cfg.projection, v.hidden)
    s["text_projection.weight"] = (cfg.projection, cfg.text.hidden)
    s["logit_scale"] = ()
    return s


def load_clip(snapshot: str, device="cuda") -> CLIPModel:
    """``<snapshot>/config.json`` and ``model.safetensors`` → a CLIPModel on
    ``device`` in FP32, through ``sd_weights.carry_params``."""
    from ..utils import safetensors
    from .sd_weights import carry_params
    cfg = read_config(snapshot)
    path = os.path.join(snapshot, "model.safetensors")
    if not os.path.exists(path):
        raise FileNotFoundError(f"CLIP weights not found at {path}")
    return carry_params(CLIPModel(cfg, device="meta"),
                        safetensors.load_file(path), "clip", device,
                        torch.float32)


def write_random_snapshot(root: str, cfg: CLIPConfig,
                          generator: torch.Generator, words,
                          device="cuda", dtype=torch.float16) -> dict:
    """A snapshot in the transformers layout for runs without a real one:
    ``config.json`` for ``cfg``, ``model.safetensors`` of seeded random
    parameters at ``sdnet.init_params``' scaling with ``logit_scale`` at
    CLIP's trained value, log 100 (drawn on ``device``, stored as
    ``dtype``), ``preprocessor_config.json`` with OpenAI's settings at the
    vision tower's size, and a synthetic tokenizer spelling ``words``
    (``tokenizer.write_synthetic_tokenizer``). Returns the file sizes."""
    from ..utils import safetensors
    from .clip_image import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
    from .sdnet import init_params
    from .tokenizer import write_synthetic_tokenizer
    os.makedirs(root, exist_ok=True)
    vocab = write_synthetic_tokenizer(root, words)
    if vocab > cfg.text.vocab_size:
        raise ValueError(f"{root}: the synthetic tokenizer needs {vocab} "
                         f"ids, the config has {cfg.text.vocab_size}")
    t, v = cfg.text, cfg.vision
    config = {
        "architectures": ["CLIPModel"], "model_type": "clip",
        "projection_dim": cfg.projection,
        "text_config": {
            "vocab_size": t.vocab_size, "hidden_size": t.hidden,
            "intermediate_size": 4 * t.hidden,
            "num_hidden_layers": t.layers,
            "num_attention_heads": t.heads,
            "max_position_embeddings": t.max_positions,
            "eos_token_id": cfg.eos_token_id, "hidden_act": "quick_gelu",
            "layer_norm_eps": 1e-5},
        "vision_config": {
            "hidden_size": v.hidden, "intermediate_size": 4 * v.hidden,
            "num_hidden_layers": v.layers, "num_attention_heads": v.heads,
            "patch_size": v.patch, "image_size": v.image_size,
            "num_channels": 3, "hidden_act": "quick_gelu",
            "layer_norm_eps": 1e-5}}
    side = v.image_size
    pre = {"do_resize": True, "size": {"shortest_edge": side},
           "resample": 3, "do_center_crop": True,
           "crop_size": {"height": side, "width": side},
           "do_rescale": True, "rescale_factor": 1 / 255,
           "do_normalize": True, "image_mean": list(OPENAI_CLIP_MEAN),
           "image_std": list(OPENAI_CLIP_STD)}
    for name, obj in (("config.json", config),
                      ("preprocessor_config.json", pre)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1)
    params = init_params({k: v for k, v in
                          clip_model_param_shapes(cfg).items() if v},
                         generator, device=device, dtype=dtype)
    params["logit_scale"] = torch.tensor(math.log(100.0), dtype=dtype,
                                         device=device)
    path = os.path.join(root, "model.safetensors")
    safetensors.save_file(params, path, metadata={"format": "pt"})
    return {name: os.path.getsize(os.path.join(root, name))
            for name in sorted(os.listdir(root))}
