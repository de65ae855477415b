"""The port's CLIP metrics (``gs2d_torch/ig2g/{clip_model,clip_image,
metrics}.py``) against the JAX package's ``ClipMetrics``, which runs
``transformers``, on random tiny ``CLIPModel`` snapshots written by
``save_pretrained``: the CLIP score and the directional similarity within
1e-5 relative under both pooling rules, ``pixel_values`` within 1e-6 of
``CLIPImageProcessor``'s, and the full-width parameter counts."""

import numpy as np
import pytest
import torch
from transformers import (CLIPConfig, CLIPImageProcessor, CLIPModel,
                          CLIPTokenizer)

from gs2d_torch.ig2g import clip_model
from gs2d_torch.ig2g.clip_image import (pixel_values,
                                        read_preprocessor_config)
from gs2d_torch.ig2g.metrics import ClipMetrics
from gs2d_torch.ig2g.tokenizer import write_synthetic_tokenizer
from gs2d_tpu.ig2g.metrics import ClipMetrics as JaxClipMetrics

from .test_torch_common import one_torch_thread  # noqa: F401

WORDS = ["a", "photo", "of", "snowy", "winter", "scene", "sunny", "summer"]
VIEWS = [(90, 160), (540, 960), (224, 224), (300, 200)]
REL = 1e-5


def _image(h, w, seed):
    """A smooth (3, H, W) float32 image in [0, 1] with some noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    f = rng.uniform(2, 9, (3, 2))
    img = 0.5 + 0.3 * np.sin(f[:, :1, None] * xx * 6.3
                             + f[:, 1:, None] * yy * 6.3)
    img = img + rng.normal(scale=0.05, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _snapshot(root, legacy: bool):
    """A tiny random CLIPModel, its tokenizer and image processor saved by
    transformers. ``legacy``: ``eos_token_id`` 2 (argmax pooling), else
    the tokenizer's end-of-text id (first-match pooling)."""
    root.mkdir()
    write_synthetic_tokenizer(str(root), WORDS)
    tok = CLIPTokenizer(str(root / "vocab.json"), str(root / "merges.txt"))
    tok.save_pretrained(str(root))
    eos = 2 if legacy else tok.eos_token_id
    cfg = CLIPConfig(
        text_config=dict(vocab_size=600, hidden_size=32,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=16,
                         eos_token_id=eos),
        vision_config=dict(hidden_size=32, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=224, patch_size=32),
        projection_dim=24, initializer_factor=4.0)
    torch.manual_seed(3 if legacy else 4)
    CLIPModel(cfg).eval().save_pretrained(str(root))
    CLIPImageProcessor().save_pretrained(str(root))
    return str(root), tok.eos_token_id


@pytest.fixture(scope="module", params=["legacy_eos_2", "eos_token"])
def snapshot(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("clip") / request.param
    path, eos = _snapshot(root, request.param == "legacy_eos_2")
    return path, eos, request.param


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_read_config_follows_the_snapshot(snapshot):
    path, eos, rule = snapshot
    cfg = clip_model.read_config(path)
    assert cfg.eos_token_id == (2 if rule == "legacy_eos_2" else eos)
    assert cfg.text.hidden == 32 and cfg.text.max_positions == 16
    assert cfg.vision.patch == 32 and cfg.vision.image_size == 224
    assert cfg.projection == 24


@pytest.mark.parametrize("hw", VIEWS, ids=[f"{h}x{w}" for h, w in VIEWS])
def test_pixel_values_match_clip_image_processor(snapshot, hw):
    path = snapshot[0]
    img = _image(*hw, seed=hw[0])
    ref = CLIPImageProcessor.from_pretrained(path)(
        images=[(img.transpose(1, 2, 0) * 255).astype(np.uint8)],
        return_tensors="pt").pixel_values
    got = pixel_values(img, read_preprocessor_config(path), "cpu")
    assert got.shape == ref.shape == (1, 3, 224, 224)
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("hw", VIEWS, ids=[f"{h}x{w}" for h, w in VIEWS])
def test_clip_score_matches_jax(snapshot, hw):
    path = snapshot[0]
    ours = ClipMetrics(path, device="cpu")
    ref = JaxClipMetrics(path)
    assert ours.available() and ref.available()
    img = _image(*hw, seed=7 + hw[1])
    for prompt in ("a photo of a snowy winter scene", "sunny summer"):
        got, want = ours.clip_score(img, prompt), ref.clip_score(img, prompt)
        assert np.isfinite(got) and abs(want) > 1e-3
        assert _rel(got, want) <= REL, (prompt, got, want)


@pytest.mark.parametrize("hw", VIEWS, ids=[f"{h}x{w}" for h, w in VIEWS])
def test_directional_similarity_matches_jax(snapshot, hw):
    """Both packages on an edit (a tinted, shifted copy of the view) and
    two captions; the value must be far from 0, so a pooling that landed
    on one position for every prompt (which gives exactly 0) cannot
    pass."""
    path = snapshot[0]
    orig = _image(*hw, seed=11)
    edit = np.clip(np.roll(orig, 5, axis=2) * np.array(
        [1.2, 0.9, 0.6], np.float32)[:, None, None], 0, 1)
    caps = ("a photo of a sunny summer scene",
            "a photo of a snowy winter scene")
    got = ClipMetrics(path, device="cpu").directional_similarity(
        orig, edit, *caps)
    want = JaxClipMetrics(path).directional_similarity(orig, edit, *caps)
    assert abs(want) > 0.05, want
    assert _rel(got, want) <= REL, (got, want)


def test_metrics_without_a_snapshot(monkeypatch):
    monkeypatch.delenv("GS2D_CLIP_DIR", raising=False)
    monkeypatch.delenv("GS2D_CLIP_LARGE_DIR", raising=False)
    m = ClipMetrics(device="cpu")
    assert not m.available()
    with pytest.raises(RuntimeError):
        m.clip_score(_image(8, 8, 0), "a photo")


def test_environment_variables_name_the_snapshots(snapshot, monkeypatch):
    monkeypatch.setenv("GS2D_CLIP_DIR", snapshot[0])
    monkeypatch.delenv("GS2D_CLIP_LARGE_DIR", raising=False)
    m = ClipMetrics(device="cpu")
    assert m.available() and m.large is not None


@pytest.mark.parametrize("cfg,count", [
    (clip_model.CLIP_VIT_B16, 149_620_737),
    (clip_model.CLIP_VIT_L14, 427_616_513)], ids=["vit_b16", "vit_l14"])
def test_full_width_parameter_counts(cfg, count):
    """transformers 4.57's counts of openai/clip-vit-base-patch16 and
    clip-vit-large-patch14 (without the position_ids buffers), on the meta
    device; the shapes table agrees with the module."""
    m = clip_model.CLIPModel(cfg, device="meta")
    assert sum(p.numel() for p in m.parameters()) == count
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes == clip_model.clip_model_param_shapes(cfg)


def _hf_tiny(**kw) -> CLIPConfig:
    """transformers' CLIPConfig of the port's TINY (eos_token_id 2)."""
    t, v = clip_model.TINY.text, clip_model.TINY.vision
    return CLIPConfig(
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.hidden,
                         intermediate_size=4 * t.hidden,
                         num_hidden_layers=t.layers,
                         num_attention_heads=t.heads,
                         max_position_embeddings=t.max_positions,
                         eos_token_id=2),
        vision_config=dict(hidden_size=v.hidden,
                           intermediate_size=4 * v.hidden,
                           num_hidden_layers=v.layers,
                           num_attention_heads=v.heads, patch_size=v.patch,
                           image_size=v.image_size),
        projection_dim=clip_model.TINY.projection, **kw)


def test_tiny_module_names_match_transformers():
    """Every parameter of transformers' CLIPModel at the TINY config has
    the port's name and shape, and no other."""
    ref = {k: tuple(p.shape)
           for k, p in CLIPModel(_hf_tiny()).named_parameters()}
    assert ref == clip_model.clip_model_param_shapes(clip_model.TINY)


def test_transformers_state_dict_carries_into_the_port():
    """A transformers CLIPModel's state dict as NumPy arrays, with the
    ``position_ids`` buffers older snapshots carry, fills the port's
    CLIPModel through ``carry_params``; image and text features agree
    within 1e-5 of the largest value."""
    from gs2d_torch.ig2g.sd_weights import carry_params
    t, v = clip_model.TINY.text, clip_model.TINY.vision
    torch.manual_seed(5)
    ref = CLIPModel(_hf_tiny(initializer_factor=4.0)).eval()
    raw = {k: p.detach().numpy() for k, p in ref.state_dict().items()}
    raw["text_model.embeddings.position_ids"] = np.arange(t.max_positions)[
        None]
    raw["vision_model.embeddings.position_ids"] = np.arange(
        (v.image_size // v.patch) ** 2 + 1)[None]
    ours = carry_params(clip_model.CLIPModel(clip_model.TINY, device="meta"),
                        raw, "clip", device="cpu")
    g = torch.Generator().manual_seed(6)
    px = torch.randn((2, 3, v.image_size, v.image_size), generator=g)
    ids = torch.randint(0, t.vocab_size - 1, (2, t.max_positions),
                        generator=g)
    ids[:, 5] = t.vocab_size - 1       # the top id: the pooled position
    with torch.no_grad():
        for a, b in ((ours.get_image_features(px),
                      ref.get_image_features(pixel_values=px)),
                     (ours.get_text_features(ids),
                      ref.get_text_features(input_ids=ids))):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
