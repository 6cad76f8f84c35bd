"""Text-similarity backends for grounding recall.

Copy of `grove_tpu/evals/textsim.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

The reference gates phrase matches on BERT sentence-embedding cosine >= 0.5
(`eval_iground.py:30-37,70-98`: mean of last hidden states). No BERT weights
exist in this environment, so the similarity function is pluggable
(`iground.find_best_matches(text_sim=...)`), with three backends:

  * `token_tf_cosine` (in `iground.py`) — TF word cosine. Strict: zero for
    any synonym/inflection ("running dog" vs "dogs run" -> 0).
  * `char_ngram_cosine` (here) — fastText-style hashed character-n-gram
    embedding cosine. Words are boundary-marked ("<dog>") and decomposed
    into 3..5-grams hashed into a fixed-dim vector; a sentence is the
    normalized sum of its word vectors. Morphological variants share most
    n-grams ("running"/"runs" -> high sim) which is the bulk of BERT's
    above-threshold matches on this task; true synonym pairs ("dog" vs
    "puppy") still score low — that gap needs real embeddings.
  * `embedding_cosine(path)` (here) — mean-pooled word-vector cosine over a
    .npz word-embedding table (word -> vector). The day real assets (e.g.
    distilled BERT token embeddings or GloVe) arrive, pass the file and the
    recall gate matches the reference's semantics with no code change.

Backends accept/reject different synonym pairs, so recall numbers are only
comparable within one backend — `run_iground` records which one was used
(see `evals/DEVIATIONS.md`).
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List

import numpy as np

_CACHE_LIMIT = 65536


def _word_features(word: str, n_min: int, n_max: int) -> List[tuple]:
    """(feature, weight) pairs for one word: a Porter-stem anchor (weight 2
    — shared by all inflections of a word, the bulk of BERT's
    above-threshold matches on this task) plus unmarked char n-grams
    (weight 1 — partial credit for compounds/typos). Boundary-marked
    fastText n-grams were tried first and scored inflection pairs ~0.2-0.3,
    far below the 0.5 gate."""
    from .meteor import porter_stem
    out = [(f"stem\x00{porter_stem(word)}", 2.0)]
    for n in range(n_min, n_max + 1):
        out.extend((word[i:i + n], 1.0)
                   for i in range(len(word) - n + 1))
    return out


class CharNgramEmbedder:
    """Hashed char-n-gram sentence embeddings (deterministic, asset-free)."""

    def __init__(self, dim: int = 2048, n_min: int = 3, n_max: int = 5):
        self.dim = dim
        self.n_min = n_min
        self.n_max = n_max
        self._word_cache: Dict[str, np.ndarray] = {}

    def _word_vec(self, word: str) -> np.ndarray:
        v = self._word_cache.get(word)
        if v is not None:
            return v
        v = np.zeros(self.dim, np.float64)
        for g, w in _word_features(word, self.n_min, self.n_max):
            h = zlib.crc32(g.encode("utf-8"))
            # sign bit decorrelates hash collisions (feature hashing)
            v[h % self.dim] += w if (h >> 31) & 1 == 0 else -w
        norm = np.linalg.norm(v)
        if norm > 0:
            v /= norm
        if len(self._word_cache) < _CACHE_LIMIT:
            self._word_cache[word] = v
        return v

    def embed(self, text: str) -> np.ndarray:
        words = text.lower().split()
        if not words:
            return np.zeros(self.dim, np.float64)
        v = np.sum([self._word_vec(w) for w in words], axis=0)
        norm = np.linalg.norm(v)
        return v / norm if norm > 0 else v

    def __call__(self, a: str, b: str) -> float:
        return float(np.dot(self.embed(a), self.embed(b)))


_default_embedder: CharNgramEmbedder | None = None


def char_ngram_cosine(a: str, b: str) -> float:
    """Module-level backend with a shared cache (the recall loop calls the
    similarity O(phrases^2) times per frame)."""
    global _default_embedder
    if _default_embedder is None:
        _default_embedder = CharNgramEmbedder()
    return _default_embedder(a, b)


def embedding_cosine(npz_path: str) -> Callable[[str, str], float]:
    """Mean-pooled word-embedding cosine from a word->vector .npz table.

    OOV words fall back to the char-n-gram embedder projected to the
    table's dimension is NOT attempted — they are simply skipped (BERT-like
    subword fallback would require the real tokenizer); sentences with no
    in-vocabulary word compare by `char_ngram_cosine`.
    """
    table = np.load(npz_path)
    vocab = {k: np.asarray(table[k], np.float64) for k in table.files}

    def embed(text: str) -> np.ndarray | None:
        vecs = [vocab[w] for w in text.lower().split() if w in vocab]
        if not vecs:
            return None
        v = np.mean(vecs, axis=0)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def sim(a: str, b: str) -> float:
        va, vb = embed(a), embed(b)
        if va is None or vb is None:
            return char_ngram_cosine(a, b)
        return float(np.dot(va, vb))

    return sim


BACKENDS = {
    "tf": None,             # resolved to iground.token_tf_cosine by callers
    "char_ngram": char_ngram_cosine,
}


def resolve_backend(name: str) -> Callable[[str, str], float]:
    """'tf' | 'char_ngram' | 'embed:<path.npz>' -> similarity callable."""
    if name == "tf":
        from .iground import token_tf_cosine
        return token_tf_cosine
    if name == "char_ngram":
        return char_ngram_cosine
    if name.startswith("embed:"):
        return embedding_cosine(name.split(":", 1)[1])
    raise ValueError(f"unknown text-sim backend {name!r} "
                     f"(tf | char_ngram | embed:<path.npz>)")
