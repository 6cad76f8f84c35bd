"""Deterministic word-level tokenizer for tests (no HF assets required).

A copy of `grove_tpu/text/mock_tokenizer.py`, so that the port imports nothing of the JAX
package; `tests/test_torch_misc.py` holds the two equal.

Implements the small protocol surface the framework needs from a LLaMA
tokenizer: callable returning `.input_ids` with a leading BOS, special tokens
as single ids, and `decode`. Word pieces hash into the base vocab range, so
tokenization is stable across processes.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .constants import (DEFAULT_EOS_TOKEN, GROVE_EXTRA_TOKENS)


@dataclass
class _Enc:
    input_ids: List[int]


class MockTokenizer:
    """Word-level tokenizer with LLaMA-like special-token behavior."""

    def __init__(self, base_vocab_size: int = 128, model_max_length: int = 512):
        self.base_vocab_size = base_vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 0
        self.pad_token_id = 0
        self._special: Dict[str, int] = {"<s>": 1, "</s>": 2, "<unk>": 0}
        self._added: List[str] = []
        for tok in GROVE_EXTRA_TOKENS:
            self.add_token(tok)
        specials = sorted(self._special, key=len, reverse=True)
        self._split_re = re.compile(
            "(" + "|".join(re.escape(s) for s in specials) + ")")
        self._rev: Dict[int, str] = {v: k for k, v in self._special.items()}

    def add_token(self, tok: str) -> int:
        if tok not in self._special:
            self._special[tok] = self.base_vocab_size + len(self._added)
            self._added.append(tok)
        return self._special[tok]

    def __len__(self) -> int:
        return self.base_vocab_size + len(self._added)

    def token_id(self, tok: str) -> int:
        return self._special[tok]

    def _word_id(self, word: str) -> int:
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        return 3 + (h % (self.base_vocab_size - 3))

    def __call__(self, text: str, add_special_tokens: bool = True) -> _Enc:
        ids: List[int] = [self.bos_token_id] if add_special_tokens else []
        for part in self._split_re.split(text):
            if not part:
                continue
            if part in self._special:
                ids.append(self._special[part])
            else:
                ids.extend(self._word_id(w) for w in part.split())
        return _Enc(ids)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        out: List[str] = []
        for i in ids:
            i = int(i)
            if i == self.bos_token_id and skip_special_tokens:
                continue
            if i in self._rev:
                if skip_special_tokens and self._rev[i] in ("<s>", "</s>"):
                    continue
                out.append(self._rev[i])
            else:
                out.append(f"w{i}")
        return " ".join(out)

    def batch_decode(self, seqs, skip_special_tokens: bool = False):
        return [self.decode(s, skip_special_tokens) for s in seqs]
