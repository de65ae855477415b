"""The port's CLIP tokenizer (gs2d_torch/ig2g/tokenizer.py) against
``transformers.CLIPTokenizer`` (here without ftfy, as the port) on the
same synthetic ``vocab.json`` / ``merges.txt`` (``write_synthetic_
tokenizer``): token ids equal on ASCII, punctuation and contractions,
digits, accented and non-Latin letters, CJK, runs of whitespace and
control characters, and a prompt that truncates at 77. Then the port's
``PromptEncoder`` against the JAX one (transformers' tokenizer, a small
text tower carried across) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import CLIPTokenizer as HFTokenizer

from gs2d_torch.ig2g import clip_text as TC
from gs2d_torch.ig2g.sd_weights import carry_params
from gs2d_torch.ig2g.tokenizer import CLIPTokenizer, write_synthetic_tokenizer
from gs2d_tpu.ig2g import clip_text as JC
from gs2d_tpu.ig2g.sdnet import init_params

from .test_torch_common import one_torch_thread  # noqa: F401

WORDS = ["a", "photo", "of", "the", "scene", "turn", "it", "into", "winter",
         "snow", "make", "look", "like", "van", "gogh", "painting", "café",
         "don't", "2024", "!!!", "wie", "привет", "東京"]

PROMPTS = [
    "a photo of the scene",
    "Turn it into WINTER, with snow!!! (and ice) don't we'll they're I'm",
    "make it 2024 models 3.14 x10 ½ ٣ Ⅻ",
    "café naïve résumé Ångström façade",
    "привет мир — 東京タワー 한국어 ελληνικά",
    "  lots\t\tof \n spaces and em​zero  ",
    "ctrl\x00chars\x07here� and\u0085next",
    "look like van gogh's painting... ?! #hash @at $100 50%",
    "",
    " ".join(["photo of the scene"] * 40),
]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokenizer")
    write_synthetic_tokenizer(str(d), WORDS)
    return d


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_ids_match_transformers(tok_dir, i):
    ref = HFTokenizer(str(tok_dir / "vocab.json"), str(tok_dir / "merges.txt"))
    assert ref.fix_text is None                 # no ftfy, as the port
    port = CLIPTokenizer.from_snapshot(str(tok_dir))
    prompts = [PROMPTS[i], ""]
    want = ref(prompts, padding="max_length", max_length=77,
               truncation=True, return_tensors="np").input_ids.tolist()
    assert port(prompts) == want
    assert len(want[0]) == 77
    assert port.tokenize(PROMPTS[i]) == ref.tokenize(PROMPTS[i])


def test_merges_are_used(tok_dir):
    """The synthetic merges spell the words: one token each."""
    port = CLIPTokenizer.from_snapshot(str(tok_dir))
    assert port.tokenize("photo of snow") == ["photo</w>", "of</w>",
                                             "snow</w>"]
    assert port.encode(" ".join(["a"] * 100))[-1] == port.eos_id


def test_prompt_encoder_matches_jax(tok_dir):
    vocab = len(HFTokenizer(str(tok_dir / "vocab.json"),
                            str(tok_dir / "merges.txt")).encoder)
    jcfg = JC.CLIPTextConfig(vocab_size=vocab, hidden=16, layers=2, heads=2,
                             max_positions=77)
    jp = init_params(JC.clip_param_shapes(jcfg), jax.random.PRNGKey(4))
    j_enc = JC.PromptEncoder(root="", cfg=jcfg, params=jp,
                             tokenizer=HFTokenizer(
                                 str(tok_dir / "vocab.json"),
                                 str(tok_dir / "merges.txt")))
    tcfg = TC.CLIPTextConfig(**jcfg.__dict__)
    model = carry_params(TC.CLIPTextModel(tcfg, device="cpu"),
                         {k: np.asarray(v) for k, v in jp.items()}, "clip",
                         "cpu")
    t_enc = TC.PromptEncoder(str(tok_dir.parent), cfg=tcfg, model=model,
                             tokenizer=CLIPTokenizer.from_snapshot(
                                 str(tok_dir)), device="cpu")
    prompt = "Turn it into winter, with snow!"
    ref = np.asarray(j_enc.encode(prompt))
    got = t_enc.encode(prompt)
    assert tuple(got.shape) == (3, 77, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[1], got[2])
    assert float(jnp.abs(ref[0] - ref[1]).max()) > 1e-3
