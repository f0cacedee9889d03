"""Pure-Python BERT WordPiece tokenizer (uncased).

Host copy of ``bsc_nav_tpu/models/wordpiece.py``; it imports nothing of
the JAX package.  Drives the Grounding DINO text tower
(``models/grounding_dino.py``) from class prompts, mirroring the HF
BertTokenizer the reference demo uses implicitly through AutoProcessor
(reference gdino.py:44-47): basic tokenization (lowercase, accent strip,
punctuation split, CJK isolation) + greedy longest-match-first WordPiece.
Held token for token to the original in tests/test_torch_host_copies.py.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    # clean: drop control chars, normalize whitespace
    out = []
    for ch in text:
        cp = ord(ch)
        # BERT _clean_text: \t\n\r are whitespace BEFORE the control
        # category check; other Cc/Cf chars are dropped
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in (
                "Cc", "Cf"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = "".join(out)

    tokens: List[str] = []
    for tok in text.split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100, lowercase: bool = True):
        self.vocab = vocab
        self.unk = unk_token
        self.max_chars = max_chars_per_word
        self.lowercase = lowercase
        self.cls_id = vocab.get("[CLS]", 101)
        self.sep_id = vocab.get("[SEP]", 102)
        self.pad_id = vocab.get("[PAD]", 0)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for tok in basic_tokenize(text, self.lowercase):
            out.extend(self._wordpiece(tok))
        return out

    def encode(self, text: str, add_special: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.vocab.get(self.unk, 100))
               for t in self.tokenize(text)]
        if add_special:
            ids = [self.cls_id] + ids + [self.sep_id]
        return ids


def classes_to_prompt(classes: Sequence[str]) -> str:
    """HF GroundingDinoProcessor convention: 'a. b. c.' lowercased."""
    return " ".join(c.strip().lower().rstrip(".") + "." for c in classes)
