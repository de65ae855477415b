"""The CLIP text tower (SD-1.5's conditioning encoder), in torch.

Counterpart of ``gs2d_tpu/ig2g/clip_text.py`` (openai/clip-vit-large-
patch14's text tower): token and learned position embeddings → pre-LN
transformer layers with a causal mask and quick-GELU MLPs → final
LayerNorm; the whole 77-token last hidden state conditions the UNet.
Modules named as the ``transformers`` state dict (``text_model...``), so
``<snapshot>/text_encoder/model.safetensors`` loads by name.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
from torch import nn

from .sdnet import attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    max_positions: int = 77


SD15_CLIP = CLIPTextConfig()
TINY_CLIP = CLIPTextConfig(vocab_size=64, hidden=16, layers=2, heads=2,
                           max_positions=8)


class _Embeddings(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden,
                                            device=device)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden,
                                               device=device)


class _SelfAttention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        h = cfg.hidden
        self.heads = cfg.heads
        self.q_proj = nn.Linear(h, h, device=device)
        self.k_proj = nn.Linear(h, h, device=device)
        self.v_proj = nn.Linear(h, h, device=device)
        self.out_proj = nn.Linear(h, h, device=device)

    def forward(self, x, mask):
        o = attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                      self.heads, mask=mask)
        return self.out_proj(o)


class _MLP(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden, 4 * cfg.hidden, device=device)
        self.fc2 = nn.Linear(4 * cfg.hidden, cfg.hidden, device=device)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))     # quick GELU


class _Layer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden, eps=1e-5, device=device)
        self.self_attn = _SelfAttention(cfg, device)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden, eps=1e-5, device=device)
        self.mlp = _MLP(cfg, device)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg, device)
                                     for _ in range(cfg.layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.embeddings = _Embeddings(cfg, device)
        self.encoder = _Encoder(cfg, device)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden, eps=1e-5,
                                             device=device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, T) int → last hidden state (B, T, hidden)."""
        T = ids.shape[1]
        x = self.embeddings.token_embedding(ids) \
            + self.embeddings.position_embedding.weight[:T]
        ar = torch.arange(T, device=ids.device)
        mask = torch.where(ar[None, :] <= ar[:, None], 0.0, -1e9)
        for layer in self.encoder.layers:
            x = layer(x, mask)
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = SD15_CLIP, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, T) int → last hidden state (B, T, hidden)."""
        return self.text_model(ids)


def clip_text_apply(model: CLIPTextModel, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, T) → last hidden state (``gs2d_tpu`` ``clip_text_apply``)."""
    return model(ids)


def clip_param_shapes(cfg: CLIPTextConfig) -> dict:
    s = {}
    pre = "text_model"
    s[f"{pre}.embeddings.token_embedding.weight"] = (cfg.vocab_size,
                                                     cfg.hidden)
    s[f"{pre}.embeddings.position_embedding.weight"] = (cfg.max_positions,
                                                        cfg.hidden)

    def lin(name, ci, co):
        s[f"{name}.weight"] = (co, ci)
        s[f"{name}.bias"] = (co,)

    def norm(name):
        s[f"{name}.weight"] = (cfg.hidden,)
        s[f"{name}.bias"] = (cfg.hidden,)

    for i in range(cfg.layers):
        ln = f"{pre}.encoder.layers.{i}"
        norm(f"{ln}.layer_norm1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{ln}.self_attn.{proj}", cfg.hidden, cfg.hidden)
        norm(f"{ln}.layer_norm2")
        lin(f"{ln}.mlp.fc1", cfg.hidden, 4 * cfg.hidden)
        lin(f"{ln}.mlp.fc2", 4 * cfg.hidden, cfg.hidden)
    norm(f"{pre}.final_layer_norm")
    return s


class PromptEncoder:
    """Prompt → (3, T, hidden) embeddings for the 3-way guidance batch
    [text, uncond, uncond] (rows aligned with the image-conditioning
    latents [cond, cond, zero] of ``ip2p.edit_image``). Loads the text
    tower and the tokenizer from the snapshot at ``root`` unless given."""

    def __init__(self, root: str, cfg: CLIPTextConfig = SD15_CLIP,
                 model: Optional[CLIPTextModel] = None, tokenizer=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if model is None:
            from .sd_weights import load_text_encoder
            model = load_text_encoder(root, cfg, device=device)
        self.model = model
        if tokenizer is None:
            from .tokenizer import CLIPTokenizer
            tokenizer = CLIPTokenizer.from_snapshot(
                os.path.join(root, "tokenizer"), cfg.max_positions)
        self.tok = tokenizer

    @torch.no_grad()
    def encode(self, prompt: str) -> torch.Tensor:
        ids = torch.as_tensor(self.tok([prompt, ""]), dtype=torch.int64,
                              device=self.device)
        emb = self.model(ids)
        text, uncond = emb[0:1], emb[1:2]
        return torch.cat([text, uncond, uncond], dim=0)
