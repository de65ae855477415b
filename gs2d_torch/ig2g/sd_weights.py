"""Weights into the port's SD modules: from a diffusers snapshot on disk,
or carried across from the JAX package's param dicts.

Counterpart of ``gs2d_tpu/ig2g/sd_weights.py``. Point ``GS2D_SD_WEIGHTS``
(or the ``root`` argument) at a diffusers snapshot of
timbrooks/instruct-pix2pix::

    <root>/unet/diffusion_pytorch_model.safetensors
    <root>/vae/diffusion_pytorch_model.safetensors
    <root>/text_encoder/model.safetensors
    <root>/tokenizer/{vocab.json,merges.txt}

The files are read by the port's own safetensors reader
(``gs2d_torch/utils/safetensors.py``). Every load goes through
``carry_params``: the VAE's legacy attention names are remapped, missing
names are reported, every shape is checked, everything is moved to the
device in the checkpoint's own dtype (a snapshot stored as F16 loads as
float16, as diffusers' ``from_pretrained(torch_dtype=torch.float16)``
gives it; ``dtype`` overrides), and the module is filled by name. The
modules are built on the meta device first, so the weights are allocated
once. ``seeded`` builds the three modules at full width from a seed
instead, in a given dtype, without a snapshot.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..utils import safetensors
from .clip_text import SD15_CLIP, CLIPTextConfig, CLIPTextModel
from .sdnet import SD15_IP2P_UNET, UNet2DCondition, UNetConfig
from .vae import SD15_VAE, AutoencoderKL, VAEConfig

ENV_VAR = "GS2D_SD_WEIGHTS"


def weights_root(root: str | None = None) -> str | None:
    """``root`` or ``$GS2D_SD_WEIGHTS`` if it is a directory; None if
    neither is set; a path that is set but not a directory raises."""
    root = root or os.environ.get(ENV_VAR)
    if root and os.path.isdir(root):
        return root
    if root:
        raise FileNotFoundError(
            f"{ENV_VAR} points at {root!r}, which is not a directory")
    return None


# The published timbrooks/instruct-pix2pix VAE was exported by an old
# diffusers that stored the mid-block attention as
# {query,key,value,proj_attn}; diffusers remaps them at load, and so does
# this loader.
_LEGACY_ATTN = {".to_q.": ".query.", ".to_k.": ".key.",
                ".to_v.": ".value.", ".to_out.0.": ".proj_attn."}


def _legacy_name(name: str):
    for new, old in _LEGACY_ATTN.items():
        if new in name:
            return name.replace(new, old)
    return None


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x))


def carry_params(module: nn.Module, raw: Mapping, what: str,
                 device="cuda", dtype=None) -> nn.Module:
    """Fill ``module`` by name from ``raw`` (numpy arrays — a JAX param
    dict through ``np.asarray``, a ``transformers`` state dict — or
    tensors): legacy VAE attention names remapped (convolution-shaped
    projections reshaped), a missing name or a wrong shape raises
    ValueError naming it, values moved to ``device`` in ``dtype``, by
    default the dtype that every value of ``raw`` shares (float32 where
    they differ). Names
    ``module`` does not have (the ``position_ids`` buffers of older CLIP
    snapshots) are ignored. Returns the module, in eval mode, without
    gradients."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    raw = dict(raw)
    for name, want in shapes.items():
        legacy = _legacy_name(name)
        if name not in raw and legacy is not None and legacy in raw:
            arr = _as_tensor(raw[legacy])
            if tuple(arr.shape) != want and tuple(arr.shape[:2]) == want[:2]:
                arr = arr.reshape(want)
            raw[name] = arr
    missing = sorted(set(shapes) - set(raw))
    if missing:
        raise ValueError(f"{what}: checkpoint is missing {len(missing)} "
                         f"params, first: {missing[:5]}")
    tensors = {name: _as_tensor(raw[name]) for name in shapes}
    if dtype is None:
        kinds = {t.dtype for t in tensors.values()}
        dtype = kinds.pop() if len(kinds) == 1 else torch.float32
    params = {}
    for name, want in shapes.items():
        t = tensors[name]
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        params[name] = t.to(device=device, dtype=dtype)
    module.load_state_dict(params, strict=True, assign=True)
    return module.requires_grad_(False).eval()


def _load(root: str, sub: str, fname: str, module: nn.Module, what: str,
          device, dtype) -> nn.Module:
    path = os.path.join(root, sub, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{what} checkpoint not found at {path}; set {ENV_VAR} to a "
            "diffusers snapshot of timbrooks/instruct-pix2pix")
    return carry_params(module, safetensors.load_file(path), what, device,
                        dtype)


def load_unet(root: str, cfg: UNetConfig = SD15_IP2P_UNET, device="cuda",
              dtype=None) -> UNet2DCondition:
    return _load(root, "unet", "diffusion_pytorch_model.safetensors",
                 UNet2DCondition(cfg, device="meta"), "unet", device, dtype)


def load_vae(root: str, cfg: VAEConfig = SD15_VAE, device="cuda",
             dtype=None) -> AutoencoderKL:
    return _load(root, "vae", "diffusion_pytorch_model.safetensors",
                 AutoencoderKL(cfg, device="meta"), "vae", device, dtype)


def load_text_encoder(root: str, cfg: CLIPTextConfig = SD15_CLIP,
                      device="cuda", dtype=None) -> CLIPTextModel:
    return _load(root, "text_encoder", "model.safetensors",
                 CLIPTextModel(cfg, device="meta"), "clip", device, dtype)


def seeded(seed: int, dtype=torch.float16, device="cuda",
           unet_cfg: UNetConfig = SD15_IP2P_UNET,
           vae_cfg: VAEConfig = SD15_VAE,
           clip_cfg: CLIPTextConfig = SD15_CLIP):
    """(UNet, VAE, text tower) with weights drawn from ``seed`` on
    ``device`` at ``init_params``' fan-in scaling, in ``dtype``: the
    modules a snapshot written from the same draws would load, for runs
    without one. One generator draws the three in that order."""
    from .clip_text import clip_param_shapes
    from .sdnet import init_params, unet_param_shapes
    from .vae import vae_param_shapes
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for build, shapes, cfg, what in (
            (UNet2DCondition, unet_param_shapes, unet_cfg, "unet"),
            (AutoencoderKL, vae_param_shapes, vae_cfg, "vae"),
            (CLIPTextModel, clip_param_shapes, clip_cfg, "clip")):
        raw = init_params(shapes(cfg), g, device=device, dtype=dtype)
        out.append(carry_params(build(cfg, device="meta"), raw, what,
                                device, dtype))
        del raw
    return tuple(out)
