"""Text tokenization for the CLIP text tower.

The reference tokenizes through open_clip's bundled BPE
(objnav_benchmark.py:539 `open_clip.tokenize`).  Here:

  - ``BPETokenizer``: a from-scratch byte-level BPE implementing the CLIP
    tokenizer algorithm; requires the public merges file
    (bpe_simple_vocab_16e6.txt.gz) supplied by the user alongside the
    converted checkpoint -- no weights/vocab ship with this repo.
  - ``HashTokenizer``: deterministic fallback (hashing whitespace tokens
    into the id range).  Used by tests and whenever no vocab file is
    configured; only suitable with randomly-initialized text towers.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import os
from functools import lru_cache
from typing import Iterable, List, Sequence, Union

import numpy as np

try:
    import regex as _re
    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is in the base image
    import re as _re
    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
        _re.IGNORECASE,
    )


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2/CLIP scheme)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip().lower()


class BPETokenizer:
    """CLIP byte-level BPE (49152 merges + 256*2 byte tokens + 2 specials)."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text)
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


class HashTokenizer:
    """Deterministic whitespace-hash tokenizer (tests / no-vocab mode)."""

    def __init__(self, vocab_size: int = 512, context_length: int = 77):
        assert vocab_size >= 16
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        out = []
        for w in _clean(text).split():
            h = int.from_bytes(
                hashlib.md5(w.encode()).digest()[:4], "little")
            out.append(h % (self.vocab_size - 2))
        return out


def tokenize(texts: Union[str, Sequence[str]], tokenizer,
             context_length: int = None, pad_id: int = 0) -> np.ndarray:
    """texts -> int32 [B, context_length] with <sot> ids <eot> and
    `pad_id` padding (open_clip.tokenize pads with 0; SD3.5's CLIP-L
    tokenizer pads with <|endoftext|> — pass pad_id=tokenizer.eot for
    that tower.  EOT-argmax pooling finds the FIRST max id either way)."""
    if isinstance(texts, str):
        texts = [texts]
    L = context_length or tokenizer.context_length
    out = np.full((len(texts), L), pad_id, np.int32)
    for i, text in enumerate(texts):
        ids = [tokenizer.sot] + tokenizer.encode(text) + [tokenizer.eot]
        if len(ids) > L:
            ids = ids[:L]
            ids[-1] = tokenizer.eot
        out[i, :len(ids)] = ids
    return out


def default_tokenizer(bpe_path: str = None, vocab_size: int = 49408):
    """BPE when the merges file is available, hash fallback otherwise."""
    if bpe_path and os.path.exists(bpe_path):
        return BPETokenizer(bpe_path)
    return HashTokenizer(vocab_size=vocab_size)
