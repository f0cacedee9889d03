"""Qwen2's byte-level BPE tokenizer, read from an HF ``tokenizer.json``.

Stands in for ``transformers.AutoTokenizer`` in the local judge
(``bsc_nav_tpu/agents/local_vlm.py:268-271``): the card's machine has
neither ``transformers`` nor ``tokenizers`` nor ``regex``.  Encoding
follows the file's pipeline as ``tokenizers`` runs it:

1. the added tokens (``<|im_start|>``, ``<|image_pad|>``, ...) are split
   out of the raw text first, leftmost and then longest;
2. each remaining piece is NFC-normalised (``unicodedata``);
3. Qwen2's ``Split`` pre-tokenizer (``QWEN2_SPLIT_PATTERN``, an isolated
   split) cuts it into words.  The pattern needs ``\\p{L}`` and ``\\p{N}``,
   which ``re`` lacks, so ``split_words`` is a scanner over ``unicodedata``
   categories that takes the pattern's alternatives in order at each
   position, as the regex engine does.  Loading a file whose pattern is
   another one raises;
4. the words' UTF-8 bytes map to GPT-2's printable byte alphabet
   (``ByteLevel``, no prefix space, no regex of its own);
5. BPE joins the pair of lowest merge rank, leftmost first, until no pair
   of the word has a rank;
6. the symbols' ids from the vocabulary.

Decoding maps the tokens' characters back to bytes (a token with a
character outside the alphabet, such as an added token's, gives its own
UTF-8 bytes) and reads them as UTF-8, an invalid sequence as U+FFFD, as the
``ByteLevel`` decoder does.
"""

from __future__ import annotations

import json
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

QWEN2_SPLIT_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# \s of the tokenizers library's regex engine (Oniguruma, UTF-8)
_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f"
                   "\u3000" + "".join(chr(c) for c in range(0x2000, 0x200b)))
# Code points that Unicode 16.0 assigns as letters / numbers and Python
# 3.12's unicodedata (Unicode 15.0) leaves unassigned; the regex engine of
# the tokenizers library knows them (found by running its Split over every
# code point; NFC agrees on all of them)
_U16_LETTERS = (
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
    (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
    (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF),
    (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_U16_NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x16130, 0x16139), (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9),
    (0x1E5F1, 0x1E5FA))
_CRLF = frozenset("\r\n")
# the contractions of the pattern's case-insensitive group, in its order;
# U+017F (long s) folds to s
_CONTRACTIONS = (("s",), ("t",), ("r", "e"), ("v", "e"), ("m",),
                 ("l", "l"), ("d",))
_FOLD = {"s": "sS\u017f", "t": "tT", "r": "rR", "e": "eE", "v": "vV",
         "m": "mM", "l": "lL", "d": "dD"}


def _major(c: str) -> str:
    """The letter of the general category (L, N, ...)."""
    cat = unicodedata.category(c)
    if cat == "Cn":
        cp = ord(c)
        if any(a <= cp <= b for a, b in _U16_LETTERS):
            return "L"
        if any(a <= cp <= b for a, b in _U16_NUMBERS):
            return "N"
    return cat[0]


def _is_letter(c: str) -> bool:
    return _major(c) == "L"


def _is_number(c: str) -> bool:
    return _major(c) == "N"


def _run(text: str, i: int, pred) -> int:
    """The end of the run of characters from ``i`` that satisfy ``pred``."""
    n = len(text)
    while i < n and pred(text[i]):
        i += 1
    return i


def _match(text: str, i: int) -> int:
    """The end of the pattern's match at ``i`` (its first alternative that
    matches, each greedy, as the regex engine backtracks)."""
    n = len(text)
    c = text[i]
    # (?i:'s|'t|'re|'ve|'m|'ll|'d)
    if c == "'":
        for tail in _CONTRACTIONS:
            if i + len(tail) < n and all(
                    text[i + 1 + j] in _FOLD[t] for j, t in enumerate(tail)):
                return i + 1 + len(tail)
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if (c not in _CRLF and not _is_letter(c) and not _is_number(c)
            and i + 1 < n and _is_letter(text[i + 1])):
        return _run(text, i + 1, _is_letter)
    if _is_letter(c):
        return _run(text, i, _is_letter)
    # \p{N}
    if _is_number(c):
        return i + 1

    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    def other(ch):
        return ch not in _SPACE and not _is_letter(ch) and not _is_number(ch)

    j = i + 1 if c == " " and i + 1 < n and other(text[i + 1]) else i
    if other(text[j]):
        return _run(text, _run(text, j, other), lambda ch: ch in _CRLF)
    # \s*[\r\n]+: up to the last CR or LF of the whitespace run
    end = _run(text, i, lambda ch: ch in _SPACE)
    last = max((k for k in range(i, end) if text[k] in _CRLF), default=-1)
    if last >= 0:
        return last + 1
    # \s+(?!\S), else \s+
    if end == n or end - i == 1:
        return end
    return end - 1


def split_words(text: str) -> List[str]:
    """Qwen2's Split pre-tokenizer (``QWEN2_SPLIT_PATTERN``, isolated):
    the matches, and the text between them (none: the pattern's last
    alternatives take any character)."""
    out, i = [], 0
    while i < len(text):
        j = _match(text, i)
        out.append(text[i:j])
        i = j
    return out


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
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
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _pipeline_checks(spec: dict) -> bool:
    """Raise unless the file's pipeline is the one this module implements;
    returns whether it normalises to NFC."""
    norm = spec.get("normalizer")
    kinds = ([n["type"] for n in norm.get("normalizers", [norm])]
             if norm else [])
    if kinds not in ([], ["NFC"]):
        raise ValueError(f"tokenizer.json: normalizer {kinds} (this "
                         "tokenizer implements NFC or none)")
    pre = spec.get("pre_tokenizer") or {}
    steps = pre.get("pretokenizers", [pre])
    split = [p for p in steps if p.get("type") == "Split"]
    byte = [p for p in steps if p.get("type") == "ByteLevel"]
    if (len(steps) != 2 or len(split) != 1 or len(byte) != 1
            or steps[0] is not split[0]):
        raise ValueError(f"tokenizer.json: pre-tokenizer "
                         f"{[p.get('type') for p in steps]} (this tokenizer "
                         "implements Split then ByteLevel)")
    s, b = split[0], byte[0]
    if (s.get("pattern", {}).get("Regex") != QWEN2_SPLIT_PATTERN
            or s.get("behavior") != "Isolated" or s.get("invert")):
        raise ValueError("tokenizer.json: the Split pattern or behaviour is "
                         "not Qwen2's, which is the one split_words scans")
    if b.get("add_prefix_space") or b.get("use_regex", True):
        raise ValueError("tokenizer.json: ByteLevel with a prefix space or "
                         "its own regex")
    model = spec["model"]
    if (model.get("type", "BPE") != "BPE" or model.get("dropout")
            or model.get("byte_fallback") or model.get("unk_token")
            or model.get("continuing_subword_prefix")
            or model.get("end_of_word_suffix") or model.get("ignore_merges")):
        raise ValueError("tokenizer.json: a BPE model with dropout, byte "
                         "fallback, an unknown token, affixes or "
                         "ignore_merges")
    if (spec.get("decoder") or {}).get("type") != "ByteLevel":
        raise ValueError("tokenizer.json: the decoder is not ByteLevel")
    return bool(kinds)


class QwenTokenizer:
    """Qwen2's byte-level BPE over an HF ``tokenizer.json``: ``encode``,
    ``decode``, ``convert_tokens_to_ids``, and the judge's ``eos_id``
    (``<|im_end|>``) and ``image_pad_id`` (``<|image_pad|>``)."""

    def __init__(self, spec: dict):
        self.nfc = _pipeline_checks(spec)
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self.ranks: Dict[Tuple[str, str], int] = {
            m: r for r, m in enumerate(merges)}
        self.added: Dict[str, int] = {}
        for t in spec.get("added_tokens", []):
            if (t.get("lstrip") or t.get("rstrip") or t.get("single_word")
                    or t.get("normalized")):
                raise ValueError(f"tokenizer.json: added token "
                                 f"{t['content']!r} strips, is a single "
                                 "word or is matched after normalisation")
            self.added[t["content"]] = t["id"]
        self.id_to_token = {i: s for s, i in self.vocab.items()}
        self.id_to_token.update({i: s for s, i in self.added.items()})
        # the added tokens by first character, longest first
        self._by_first: Dict[str, List[str]] = {}
        for tok in sorted(self.added, key=len, reverse=True):
            self._by_first.setdefault(tok[0], []).append(tok)
        self._cache: Dict[str, List[int]] = {}
        self.eos_id = self.convert_tokens_to_ids("<|im_end|>")
        self.image_pad_id = self.convert_tokens_to_ids("<|image_pad|>")

    @classmethod
    def from_file(cls, path: str) -> "QwenTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    @property
    def vocab_size(self) -> int:
        return max(self.id_to_token) + 1

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        return self.added.get(token, self.vocab.get(token))

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is_added) in order: added tokens matched leftmost, the
        longest at a position."""
        out, i, start = [], 0, 0
        while i < len(text):
            hit = next((t for t in self._by_first.get(text[i], ())
                        if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if start < i:
                out.append((text[start:i], False))
            out.append((hit, True))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], False))
        return out

    def _bpe(self, word: str) -> List[int]:
        if word in self._cache:
            return self._cache[word]
        syms = list(word)
        while len(syms) > 1:
            best, at = None, -1
            for k in range(len(syms) - 1):
                r = self.ranks.get((syms[k], syms[k + 1]))
                if r is not None and (best is None or r < best):
                    best, at = r, k
            if best is None:
                break
            syms[at:at + 2] = [syms[at] + syms[at + 1]]
        ids = [self.vocab[s] for s in syms]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece, is_added in self._split_added(text):
            if is_added:
                ids.append(self.added[piece])
                continue
            if self.nfc:
                piece = unicodedata.normalize("NFC", piece)
            for word in split_words(piece):
                ids.extend(self._bpe("".join(
                    _BYTE_CHAR[b] for b in word.encode("utf-8"))))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        for i in ids:
            tok = self.id_to_token[int(i)]
            if all(c in _CHAR_BYTE for c in tok):
                out.extend(_CHAR_BYTE[c] for c in tok)
            else:
                out.extend(tok.encode("utf-8"))
        return out.decode("utf-8", errors="replace")
