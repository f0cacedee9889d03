"""Pure-Python sentencepiece unigram tokenizer (no native lib needed).

The reference pins `sentencepiece==0.2.0` (requirements.txt:169) for the
T5 text encoder that conditions SD3.5 imagination (memory_2.py:555-559
via diffusers' StableDiffusion3Pipeline).  That wheel is not available
in this image, so this module reimplements the inference half of
sentencepiece from scratch:

  * a minimal protobuf *wire-format* parser for `spiece.model`
    (ModelProto: field 1 = repeated SentencePiece{piece, score, type}) —
    no protobuf runtime required, unknown fields are skipped by wire
    type;
  * sentencepiece's default normalization: NFKC (stdlib unicodedata),
    extra-whitespace collapse, whitespace -> U+2581 "▁" escape, dummy
    "▁" prefix;
  * exact unigram-LM Viterbi segmentation (max sum of piece
    log-probs), with single-char <unk> fallback and optional byte
    fallback (piece type BYTE, used by e.g. llama-family models).

Only encoding/decoding is supported (no training).  T5 specifics
(pad=0, </s>=1, <unk>=2, trailing EOS) live in the `tokenize_t5`
convenience wrapper.
"""

from __future__ import annotations

import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WS = "▁"  # ▁ sentencepiece whitespace escape

# SentencePiece piece types (sentencepiece_model.proto enum)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# protobuf wire-format reader (just enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:                       # varint
        _, i = _read_varint(buf, i)
    elif wire == 1:                     # 64-bit
        i += 8
    elif wire == 2:                     # length-delimited
        n, i = _read_varint(buf, i)
        i += n
    elif wire == 5:                     # 32-bit
        i += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return i


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value_or_span) over a message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
            yield fnum, wire, v
        elif wire == 5:
            yield fnum, wire, buf[i:i + 4]
            i += 4
        elif wire == 1:
            yield fnum, wire, buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            yield fnum, wire, buf[i:i + ln]
            i += ln
        else:
            i = _skip_field(buf, i, wire)


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, NORMAL
    for fnum, wire, val in _iter_fields(buf):
        if fnum == 1 and wire == 2:
            piece = val.decode("utf-8")
        elif fnum == 2 and wire == 5:
            score = struct.unpack("<f", val)[0]
        elif fnum == 3 and wire == 0:
            ptype = val
    return piece, score, ptype


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """ModelProto bytes -> [(piece, score, type)] in vocab-id order."""
    pieces = []
    for fnum, wire, val in _iter_fields(data):
        if fnum == 1 and wire == 2:     # repeated SentencePiece pieces
            pieces.append(_parse_piece(val))
    return pieces


# ---------------------------------------------------------------------------
# serializer (tests + fixture construction; also handy for exporting
# reduced vocabularies)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wire: int) -> bytes:
    return _varint(fnum << 3 | wire)


def serialize_model_proto(pieces: Sequence[Tuple[str, float, int]]) -> bytes:
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        enc = piece.encode("utf-8")
        body += _tag(1, 2) + _varint(len(enc)) + enc
        body += _tag(2, 5) + struct.pack("<f", score)
        body += _tag(3, 0) + _varint(ptype)
        out += _tag(1, 2) + _varint(len(body)) + bytes(body)
    return bytes(out)


# ---------------------------------------------------------------------------
# unigram tokenizer
# ---------------------------------------------------------------------------

@dataclass
class SentencePieceUnigram:
    pieces: List[str]
    scores: np.ndarray                       # [vocab] float32 log-probs
    types: List[int]
    vocab: Dict[str, int] = field(init=False)
    unk_id: int = field(init=False)
    byte_ids: Optional[Dict[int, int]] = field(init=False)
    max_piece_chars: int = field(init=False)
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True

    def __post_init__(self):
        self.vocab = {}
        self.unk_id = -1
        self.byte_ids = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t == UNKNOWN:
                self.unk_id = i
            elif t == BYTE:
                # pieces look like "<0xAB>"
                self.byte_ids[int(p[1:-1], 16)] = i
            if t in (NORMAL, USER_DEFINED, UNKNOWN):
                self.vocab[p] = i
        if not self.byte_ids:
            self.byte_ids = None
        self.max_piece_chars = max(
            (len(p) for p, t in zip(self.pieces, self.types)
             if t in (NORMAL, USER_DEFINED)), default=1)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_model_bytes(cls, data: bytes) -> "SentencePieceUnigram":
        pieces = parse_model_proto(data)
        return cls(pieces=[p for p, _, _ in pieces],
                   scores=np.asarray([s for _, s, _ in pieces], np.float32),
                   types=[t for _, _, t in pieces])

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceUnigram":
        with open(path, "rb") as f:
            return cls.from_model_bytes(f.read())

    # -- normalization ------------------------------------------------------
    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", WS)

    # -- Viterbi segmentation -----------------------------------------------
    def encode(self, text: str, out_pieces: bool = False):
        """Unigram Viterbi: segmentation maximizing sum of piece scores.

        Unknown characters fall back to the BYTE pieces when the model
        has them, else to a single <unk> token (sentencepiece's
        kUnkPenalty = 10 below the min piece score).
        """
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return [] if not out_pieces else ([], [])
        NEG = -1e18
        unk_score = float(self.scores.min() if len(self.scores) else 0.0) - 10.0
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)   # (start, id)
        maxlen = self.max_piece_chars
        for end in range(1, n + 1):
            lo = max(0, end - maxlen)
            for start in range(lo, end):
                if best[start] <= NEG:
                    continue
                pid = self.vocab.get(s[start:end], -1)
                if pid < 0:
                    continue
                cand = best[start] + float(self.scores[pid])
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (start, pid)
            # single-char unknown fallback keeps the lattice connected
            if best[end] <= NEG and best[end - 1] > NEG:
                best[end] = best[end - 1] + unk_score
                back[end] = (end - 1, self.unk_id)

        ids: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ch = s[start:pos]
            if pid == self.unk_id and self.byte_ids is not None:
                for b in reversed(ch.encode("utf-8")):
                    ids.append(self.byte_ids[b])
            else:
                ids.append(pid)
            pos = start
        ids.reverse()
        if out_pieces:
            return ids, [self.pieces[i] for i in ids]
        return ids

    # -- decoding -----------------------------------------------------------
    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        pending: List[int] = []        # byte-fallback accumulator

        def flush():
            if pending:
                out.append(bytes(pending).decode("utf-8", errors="replace"))
                pending.clear()

        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self.pieces):
                continue
            t = self.types[i]
            if t == BYTE:
                pending.append(int(self.pieces[i][1:-1], 16))
                continue
            flush()
            if t in (CONTROL, UNUSED):
                continue
            out.append(self.pieces[i])
        flush()
        return "".join(out).replace(WS, " ").lstrip(" ")


def tokenize_t5(sp: SentencePieceUnigram, texts: Sequence[str],
                max_len: int = 77, eos_id: int = 1,
                pad_id: int = 0) -> np.ndarray:
    """T5-style batch tokenization: ids + </s>, right-padded with <pad>.

    Matches HF T5Tokenizer conventions (pad=0, </s>=1) used by the
    reference's diffusers pipeline text path.
    """
    out = np.full((len(texts), max_len), pad_id, np.int32)
    for r, t in enumerate(texts):
        ids = sp.encode(t)[: max_len - 1] + [eos_id]
        out[r, : len(ids)] = ids
    return out
