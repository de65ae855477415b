"""The CLIP BPE tokenizer, without ``transformers``, ``regex`` or ``ftfy``.

The JAX package takes ``transformers.CLIPTokenizer`` for the prompt
(``gs2d_tpu/ig2g/clip_text.py:139-141``). This is the same tokenizer as
that class runs where ``ftfy`` is not installed, read from a diffusers
snapshot's ``tokenizer/vocab.json`` and ``merges.txt``:

1. text clean-up as ``BasicTokenizer(strip_accents=False,
   do_split_on_punc=False)``: NUL, U+FFFD and control characters dropped,
   whitespace to spaces, spaces around CJK ideographs, NFC, lower case,
   whitespace runs joined by one space;
2. the CLIP split pattern ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|
   'm|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` as a scanner, the
   letter and number classes taken from ``unicodedata`` categories (L*, N*);
3. each piece's UTF-8 bytes through the byte-to-unicode table, then BPE
   with ``</w>`` on the last symbol, merges ranked by their line in
   ``merges.txt`` (the first line is a header; at most 48,894 merges);
4. ``<|startoftext|>`` + ids + ``<|endoftext|>``, truncated and padded
   with the pad token to ``max_length`` (77).
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import List

SPECIALS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
MAX_MERGES = 49152 - 256 - 2


def bytes_to_unicode() -> dict:
    """The reversible byte → printable character table of GPT-2 / CLIP."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """Step 1: BasicTokenizer's clean-up, lower case and re-spacing."""
    out = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        if ch in " \t\n\r" or cat == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or cat.startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def _kind(ch: str) -> str:
    if ch.isspace():
        return "space"
    cat = unicodedata.category(ch)
    return "letter" if cat[0] == "L" else "number" if cat[0] == "N" \
        else "other"


def split_pieces(text: str) -> List[str]:
    """Step 2: the pieces ``re.findall(CLIP pattern, text)`` gives."""
    pieces, i, n = [], 0, len(text)
    while i < n:
        match = next((s for s in SPECIALS if text.startswith(s, i)), None)
        if match is None:
            low = text[i:i + 3].lower()
            match = next((c for c in CONTRACTIONS if low.startswith(c)),
                         None)
            if match is not None:
                match = text[i:i + len(match)]
        if match is not None:
            pieces.append(match)
            i += len(match)
            continue
        kind = _kind(text[i])
        if kind == "space":
            i += 1
            continue
        j = i + 1
        if kind != "number":
            while j < n and _kind(text[j]) == kind:
                j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


class CLIPTokenizer:
    """``CLIPTokenizer(vocab.json, merges.txt)``; ``__call__`` gives the
    ids of ``tokenizer(prompts, padding="max_length",
    max_length=max_length, truncation=True).input_ids``."""

    def __init__(self, vocab_file: str, merges_file: str,
                 pad_token: str = "<|endoftext|>", max_length: int = 77):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        self.bpe_ranks = {tuple(m.split()): r for r, m in enumerate(lines)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder[SPECIALS[0]]
        self.eos_id = self.encoder[SPECIALS[1]]
        self.pad_id = self.encoder[pad_token]
        self.unk_id = self.encoder[SPECIALS[1]]
        self.max_length = max_length
        self.cache = {s: s for s in SPECIALS}

    @classmethod
    def from_snapshot(cls, tokenizer_dir: str, max_length: int = 77):
        """From ``<snapshot>/tokenizer``; the pad token from its
        ``special_tokens_map.json`` where there is one."""
        pad = "<|endoftext|>"
        smap = os.path.join(tokenizer_dir, "special_tokens_map.json")
        if os.path.exists(smap):
            with open(smap, encoding="utf-8") as f:
                entry = json.load(f).get("pad_token", pad)
            pad = entry["content"] if isinstance(entry, dict) else entry
        return cls(os.path.join(tokenizer_dir, "vocab.json"),
                   os.path.join(tokenizer_dir, "merges.txt"),
                   pad_token=pad, max_length=max_length)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        toks = []
        for piece in split_pieces(basic_clean(text)):
            piece = "".join(self.byte_encoder[b]
                            for b in piece.encode("utf-8"))
            toks.extend(self.bpe(piece).split(" "))
        return toks

    def encode(self, text: str) -> List[int]:
        ids = [self.encoder.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = [self.bos_id] + ids[:self.max_length - 2] + [self.eos_id]
        return ids + [self.pad_id] * (self.max_length - len(ids))

    def __call__(self, prompts) -> List[List[int]]:
        return [self.encode(p) for p in prompts]


def write_synthetic_tokenizer(tokenizer_dir: str, words) -> int:
    """A tokenizer directory in CLIP's layout for runs without a real
    snapshot: ``vocab.json`` with the 256 byte symbols, their ``</w>``
    forms, the merges that spell each of ``words`` left to right, and the
    two specials; ``merges.txt`` with its header line. Returns the
    vocabulary's size."""
    enc = bytes_to_unicode()
    symbols = [enc[b] for b in range(256)]
    vocab = symbols + [s + "</w>" for s in symbols]
    merges, seen = [], set(vocab)
    for word in words:
        syms = [enc[b] for b in word.lower().encode("utf-8")]
        syms[-1] += "</w>"
        cur = syms[0]
        for s in syms[1:]:
            if cur + s not in seen:
                merges.append(f"{cur} {s}")
                vocab.append(cur + s)
                seen.add(cur + s)
            cur += s
    vocab += list(SPECIALS)
    os.makedirs(tokenizer_dir, exist_ok=True)
    with open(os.path.join(tokenizer_dir, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(tokenizer_dir, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return len(vocab)
