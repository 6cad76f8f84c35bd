"""From-spec pure-python SentencePiece: .model proto parse + encode/decode.

This environment ships no `sentencepiece` wheel and no HF tokenizer assets,
but released GROVE/LLaMA checkpoints come with a SentencePiece
`tokenizer.model` (the reference loads it via AutoTokenizer,
`train.py:124-159`; `tokenization_grove.py:10-47`). This module removes the
last mock from the production path: the day real assets arrive,
`load_grove_tokenizer` works with no external dependency.

Implemented from the published SentencePiece spec/sources:
  * `sentencepiece_model.proto` wire format — a minimal protobuf reader and
    writer (varint / 32-bit float / length-delimited) for the fields the
    runtime needs: pieces (piece, score, type), TrainerSpec (model_type,
    byte_fallback, unk/bos/eos/pad ids), NormalizerSpec (add_dummy_prefix,
    remove_extra_whitespaces, escape_whitespaces, name).
  * Unigram encoding: Viterbi over the piece lattice; positions with no
    single-char piece get an UNK edge scored `min_score - 10` (spm's
    kUnkPenalty); UNK segments re-expand to `<0xXX>` BYTE pieces when
    `byte_fallback` is set (LLaMA convention).
  * BPE encoding (LLaMA's model_type): greedy highest-score adjacent-pair
    merges, leftmost on ties (bpe_model.cc agenda order); leftover symbols
    fall back to bytes/UNK.
  * Normalization: whitespace handling per NormalizerSpec (dummy-prefix
    "▁", extra-whitespace removal, escaping). DEVIATION: the precompiled
    NFKC charsmap (a double-array trie blob) is not interpreted; for
    non-"identity" normalizers we approximate with unicodedata NFKC.
    LLaMA models normalize whitespace only, where this is exact.

`SentencePieceTokenizer` wraps the model in the HF-slow-tokenizer protocol
surface the framework uses (callable -> .input_ids with BOS, decode,
add_tokens with append-at-end ids, pad=unk), matching the reference's
registration order for the GROVE special tokens.
"""

from __future__ import annotations

import dataclasses
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

WS = "▁"  # ▁

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2
_UNK_PENALTY = 10.0


# ---------------------------------------------------------------------------
# minimal protobuf wire format
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples; value is int for
    varint/fixed, bytes for length-delimited."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:                       # varint
            val, i = _read_varint(buf, i)
        elif wt == 1:                     # 64-bit
            val = int.from_bytes(buf[i:i + 8], "little")
            i += 8
        elif wt == 2:                     # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:                     # 32-bit
            val = int.from_bytes(buf[i:i + 4], "little")
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


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


def _field(num: int, wt: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wt) + payload


def _f_varint(num: int, v: int) -> bytes:
    return _field(num, 0, _varint(v))


def _f_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2, _varint(len(v)) + v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5, struct.pack("<f", v))


# ---------------------------------------------------------------------------
# model proto
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpModel:
    pieces: List[Tuple[str, float, int]]   # (piece, score, type)
    model_type: int = UNIGRAM
    byte_fallback: bool = False
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    normalizer_name: str = "identity"
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1


def parse_model(data: bytes) -> SpModel:
    pieces: List[Tuple[str, float, int]] = []
    m = SpModel(pieces)
    for field, wt, val in _iter_fields(data):
        if field == 1 and wt == 2:        # SentencePiece
            piece, score, typ = "", 0.0, NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2.to_bytes(4, "little"))[0]
                elif f2 == 3:
                    typ = v2
            pieces.append((piece, score, typ))
        elif field == 2 and wt == 2:      # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3:
                    m.model_type = v2
                elif f2 == 35:
                    m.byte_fallback = bool(v2)
                elif f2 == 40:
                    m.unk_id = _zigzag_int(v2)
                elif f2 == 41:
                    m.bos_id = _zigzag_int(v2)
                elif f2 == 42:
                    m.eos_id = _zigzag_int(v2)
                elif f2 == 43:
                    m.pad_id = _zigzag_int(v2)
        elif field == 3 and wt == 2:      # NormalizerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    m.normalizer_name = v2.decode("utf-8")
                elif f2 == 3:
                    m.add_dummy_prefix = bool(v2)
                elif f2 == 4:
                    m.remove_extra_whitespaces = bool(v2)
                elif f2 == 5:
                    m.escape_whitespaces = bool(v2)
    return m


def _zigzag_int(v: int) -> int:
    """proto int32 negatives arrive as 10-byte two's-complement varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


def serialize_model(m: SpModel) -> bytes:
    """Inverse of `parse_model` (fixture building + save_pretrained)."""
    out = bytearray()
    for piece, score, typ in m.pieces:
        sp = (_f_bytes(1, piece.encode("utf-8")) + _f_float(2, score)
              + _f_varint(3, typ))
        out += _f_bytes(1, sp)
    trainer = (_f_varint(3, m.model_type)
               + _f_varint(35, int(m.byte_fallback))
               + _f_varint(40, m.unk_id & ((1 << 64) - 1))
               + _f_varint(41, m.bos_id & ((1 << 64) - 1))
               + _f_varint(42, m.eos_id & ((1 << 64) - 1))
               + _f_varint(43, m.pad_id & ((1 << 64) - 1)))
    out += _f_bytes(2, trainer)
    norm = (_f_bytes(1, m.normalizer_name.encode("utf-8"))
            + _f_varint(3, int(m.add_dummy_prefix))
            + _f_varint(4, int(m.remove_extra_whitespaces))
            + _f_varint(5, int(m.escape_whitespaces)))
    out += _f_bytes(3, norm)
    return bytes(out)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

class SpProcessor:
    """Encode/decode for a parsed SpModel (unigram Viterbi or BPE merge)."""

    def __init__(self, model: SpModel):
        self.model = model
        self.piece_to_id: Dict[str, int] = {}
        self.byte_to_id: Dict[int, int] = {}
        self.matchable: Dict[str, Tuple[int, float]] = {}
        for i, (piece, score, typ) in enumerate(model.pieces):
            self.piece_to_id.setdefault(piece, i)
            if typ == BYTE:
                # "<0xAB>" -> 0xAB
                self.byte_to_id[int(piece[3:-1], 16)] = i
            elif typ in (NORMAL, USER_DEFINED):
                if piece not in self.matchable:
                    self.matchable[piece] = (i, score)
        self.max_piece_len = max((len(p) for p in self.matchable), default=1)
        scores = [s for _, s, t in model.pieces if t == NORMAL]
        self.min_score = min(scores, default=0.0)
        self.unk_score = self.min_score - _UNK_PENALTY

    # -- normalization ----------------------------------------------------

    def normalize(self, text: str) -> str:
        m = self.model
        if m.normalizer_name not in ("identity", ""):
            # DEVIATION: precompiled charsmap not interpreted; NFKC is the
            # base of every built-in non-identity spm normalizer
            text = unicodedata.normalize("NFKC", text)
        if m.remove_extra_whitespaces:
            text = " ".join(text.split())
        if m.add_dummy_prefix and text:
            text = " " + text
        if m.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    # -- encode -----------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        text = self.normalize(text)
        if not text:
            return []
        if self.model.model_type == BPE:
            return self._encode_bpe(text)
        return self._encode_unigram(text)

    def _fallback_ids(self, segment: str) -> List[int]:
        """UNK segment -> byte pieces (byte_fallback) or unk_id."""
        if self.model.byte_fallback:
            ids = []
            for b in segment.encode("utf-8"):
                bid = self.byte_to_id.get(b)
                ids.append(bid if bid is not None else self.model.unk_id)
            return ids
        return [self.model.unk_id]

    def _encode_unigram(self, text: str) -> List[int]:
        n = len(text)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id|-1)
        for i in range(n):
            if best[i] == NEG:
                continue
            has_single = False
            for ln in range(1, min(self.max_piece_len, n - i) + 1):
                cand = text[i:i + ln]
                hit = self.matchable.get(cand)
                if hit is None:
                    continue
                if ln == 1:
                    has_single = True
                pid, score = hit
                if best[i] + score > best[i + ln]:
                    best[i + ln] = best[i] + score
                    back[i + ln] = (i, pid)
            if not has_single:
                # spm: every position keeps an UNK edge so the lattice
                # always reaches the end
                if best[i] + self.unk_score > best[i + 1]:
                    best[i + 1] = best[i] + self.unk_score
                    back[i + 1] = (i, -1)
        ids: List[int] = []
        pos = n
        segs: List[Tuple[int, int, int]] = []
        while pos > 0:
            start, pid = back[pos]
            segs.append((start, pos, pid))
            pos = start
        prev_unk = False
        for start, end, pid in reversed(segs):
            if pid < 0:
                if self.model.byte_fallback:
                    ids.extend(self._fallback_ids(text[start:end]))
                elif not prev_unk:
                    # spm merges a contiguous unknown run into ONE unk
                    ids.append(self.model.unk_id)
                prev_unk = True
            else:
                ids.append(pid)
                prev_unk = False
        return ids

    def _encode_bpe(self, text: str) -> List[int]:
        symbols = list(text)
        while len(symbols) > 1:
            best_score, best_pos = None, -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                hit = self.matchable.get(merged)
                if hit is None:
                    continue
                score = hit[1]
                if best_score is None or score > best_score:
                    best_score, best_pos = score, i  # leftmost on ties
            if best_pos < 0:
                break
            symbols[best_pos:best_pos + 2] = [
                symbols[best_pos] + symbols[best_pos + 1]]
        ids: List[int] = []
        for sym in symbols:
            hit = self.matchable.get(sym)
            if hit is not None:
                ids.append(hit[0])
            elif len(sym) == 1:
                ids.extend(self._fallback_ids(sym))
            else:
                for ch in sym:
                    ids.extend(self._fallback_ids(ch))
        return ids

    # -- decode -----------------------------------------------------------

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        byte_run: List[int] = []

        def flush_bytes():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.model.pieces):
                continue
            piece, _, typ = self.model.pieces[i]
            if typ == BYTE:
                byte_run.append(int(piece[3:-1], 16))
                continue
            flush_bytes()
            if typ in (CONTROL, UNKNOWN):
                if not skip_special_tokens:
                    if typ == UNKNOWN:
                        out.append(" ⁇ ")   # spm's unk surface
                    else:
                        out.append(piece)
                continue
            out.append(piece)
        flush_bytes()
        text = "".join(out).replace(WS, " ")
        return text[1:] if text.startswith(" ") else text


# ---------------------------------------------------------------------------
# HF-protocol wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Enc:
    input_ids: List[int]


class SentencePieceTokenizer:
    """LLaMA-convention tokenizer over a .model file, HF slow-tokenizer
    protocol surface (the same one `MockTokenizer` implements).

    Added tokens (`add_tokens`, the reference registers GROVE_EXTRA_TOKENS
    this way, `train.py:124-159`) get ids appended after the base vocab and
    are split out of the text greedily (longest first) before
    SentencePiece encoding, per HF behavior; each chunk between added
    tokens is spm-encoded independently (HF legacy=True semantics, the
    LLaMA default: the dummy prefix applies per chunk).
    """

    def __init__(self, model: SpModel, model_max_length: int = 1536):
        import re
        self._re = re
        self.model = model
        self.proc = SpProcessor(model)
        self.model_max_length = model_max_length
        self.padding_side = "right"
        self._added: Dict[str, int] = {}
        self._added_rev: Dict[int, str] = {}
        self._split = None
        self.bos_token_id = model.bos_id if model.bos_id >= 0 else None
        self.eos_token_id = model.eos_id if model.eos_id >= 0 else None
        self.unk_token_id = model.unk_id if model.unk_id >= 0 else 0
        # reference sets pad = unk (`train.py:141`)
        self.pad_token_id = self.unk_token_id

    @classmethod
    def from_file(cls, path: str, model_max_length: int = 1536):
        with open(path, "rb") as f:
            return cls(parse_model(f.read()), model_max_length)

    # -- vocab management -------------------------------------------------

    def __len__(self) -> int:
        return len(self.model.pieces) + len(self._added)

    def add_tokens(self, tokens, special_tokens: bool = True) -> int:
        added = 0
        for t in list(tokens) if not isinstance(tokens, str) else [tokens]:
            if t in self._added or t in self.proc.piece_to_id:
                continue
            tid = len(self.model.pieces) + len(self._added)
            self._added[t] = tid
            self._added_rev[tid] = t
            added += 1
        if added:
            pats = sorted(self._added, key=len, reverse=True)
            self._split = self._re.compile(
                "(" + "|".join(self._re.escape(p) for p in pats) + ")")
        return added

    def add_token(self, tok: str) -> int:
        self.add_tokens([tok])
        return self.token_id(tok)

    def token_id(self, tok: str) -> int:
        if tok in self._added:
            return self._added[tok]
        pid = self.proc.piece_to_id.get(tok)
        if pid is None:
            raise KeyError(tok)
        return pid

    def convert_tokens_to_ids(self, tok):
        if isinstance(tok, str):
            return self.token_id(tok)
        return [self.token_id(t) for t in tok]

    # -- encode / decode --------------------------------------------------

    def __call__(self, text: str, add_special_tokens: bool = True,
                 truncation: bool = False, max_length: Optional[int] = None):
        ids: List[int] = []
        if add_special_tokens and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        parts = self._split.split(text) if self._split else [text]
        for part in parts:
            if not part:
                continue
            if part in self._added:
                ids.append(self._added[part])
            else:
                ids.extend(self.proc.encode(part))
        if truncation:
            ids = ids[:max_length or self.model_max_length]
        return _Enc(ids)

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                out.append(self.proc.decode(run, skip_special_tokens))
                run.clear()

        for i in ids:
            i = int(i)
            if i in self._added_rev:
                flush()
                out.append(self._added_rev[i])
            else:
                run.append(i)
        flush()
        return " ".join(s for s in out if s)

    def batch_decode(self, seqs, skip_special_tokens: bool = False):
        return [self.decode(s, skip_special_tokens) for s in seqs]

    def save_pretrained(self, path: str) -> None:
        import json
        import os
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "tokenizer.model"), "wb") as f:
            f.write(serialize_model(self.model))
        with open(os.path.join(path, "added_tokens.json"), "w") as f:
            json.dump(self._added, f, indent=1, sort_keys=True)

    @classmethod
    def from_pretrained(cls, path: str, model_max_length: int = 1536):
        import json
        import os
        tok = cls.from_file(os.path.join(path, "tokenizer.model"),
                            model_max_length)
        added_path = os.path.join(path, "added_tokens.json")
        if os.path.exists(added_path):
            with open(added_path) as f:
                added = json.load(f)
            for t, _ in sorted(added.items(), key=lambda kv: kv[1]):
                tok.add_tokens([t])
        return tok
