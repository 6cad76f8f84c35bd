"""GroveTokenizer: HF tokenizer wrapper with GROVE special tokens.

Equivalent of `grove_transformers/tokenization_grove.py:10-47`: loads a LLaMA
tokenizer, registers the GROVE special tokens in the reference order, and
exposes their ids as a `SpecialTokenIds` for the model config. (No HF assets
ship in this environment; tests use `MockTokenizer`, which implements the
same protocol.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..config import SpecialTokenIds
from .constants import (BOP_TOKEN, DEFAULT_BBOX_TOKEN, DEFAULT_POINT_TOKEN,
                        DEFAULT_VID_END_TOKEN, DEFAULT_VID_START_TOKEN,
                        DET_TOKEN, EOP_TOKEN, GROVE_EXTRA_TOKENS)


def load_grove_tokenizer(name_or_path: str, model_max_length: int = 1536):
    """Tokenizer + GROVE special tokens (reference `train.py:124-159`).

    A bare SentencePiece `.model` file (or a dir containing
    `tokenizer.model` with no HF wrapper installed/configured) loads via
    the from-spec pure-python implementation (`text/sentencepiece.py`) —
    no HF assets or `sentencepiece` wheel needed. Otherwise defers to
    AutoTokenizer like the reference. Registration order of the extra
    tokens matches the reference in both paths.
    """
    import os

    def _from_spec(model_path: str):
        from .sentencepiece import SentencePieceTokenizer
        tok = SentencePieceTokenizer.from_file(model_path, model_max_length)
        tok.add_tokens(list(GROVE_EXTRA_TOKENS), special_tokens=True)
        return tok

    if name_or_path.endswith(".model") and os.path.isfile(name_or_path):
        return _from_spec(name_or_path)
    sp_path = os.path.join(name_or_path, "tokenizer.model")
    try:
        import transformers
        tok = transformers.AutoTokenizer.from_pretrained(
            name_or_path, model_max_length=model_max_length,
            padding_side="right", use_fast=False)
        tok.pad_token = tok.unk_token
        tok.add_tokens(list(GROVE_EXTRA_TOKENS), special_tokens=True)
        return tok
    except Exception:
        # HF needs tokenizer_config/sentencepiece wheel; the .model file
        # alone is enough for the from-spec path
        if os.path.isfile(sp_path):
            return _from_spec(sp_path)
        raise


def special_token_ids_from(tokenizer) -> SpecialTokenIds:
    """Capture the GROVE special-token ids from any tokenizer implementing
    the HF surface (or MockTokenizer)."""
    def tid(s: str) -> int:
        if hasattr(tokenizer, "token_id"):
            return tokenizer.token_id(s)
        ids = tokenizer(s, add_special_tokens=False).input_ids
        # LLaMA sentencepiece may prefix a space token; take the last id
        return ids[-1]

    return SpecialTokenIds(
        det=tid(DET_TOKEN),
        bop=tid(BOP_TOKEN),
        eop=tid(EOP_TOKEN),
        bbox=tid(DEFAULT_BBOX_TOKEN),
        point=tid(DEFAULT_POINT_TOKEN),
        vid_start=tid(DEFAULT_VID_START_TOKEN),
        vid_end=tid(DEFAULT_VID_END_TOKEN),
        pad=tokenizer.pad_token_id or 0,
        bos=tokenizer.bos_token_id,
        eos=tokenizer.eos_token_id,
        unk=getattr(tokenizer, "unk_token_id", 0) or 0,
    )
