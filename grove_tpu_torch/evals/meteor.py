"""Pure-python METEOR (exact + Porter-stem matching stages).

Copy of `grove_tpu/evals/meteor.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

The reference computes METEOR via pycocoevalcap's bundled METEOR-1.5 Java
jar (`eval_iground.py:461-468`). That jar (and its WordNet synonym /
paraphrase tables) is not available in this environment, so this module
implements the METEOR algorithm (Banerjee & Lavie 2005; Lavie & Agarwal
2007) directly with the two asset-free matcher stages:

  1. exact surface match,
  2. Porter-stem match on the leftovers,

followed by the standard fragmentation penalty:

  P = m / |hyp|,  R = m / |ref|
  F_mean  = P * R / (alpha * P + (1 - alpha) * R)
  penalty = gamma * (chunks / m) ** beta
  score   = F_mean * (1 - penalty)

with the classic parameters alpha=0.9, beta=3.0, gamma=0.5 (the same
parameters as nltk.translate.meteor_score, minus its optional
WordNet-synonym stage). The word alignment is a single left-to-right pass
preferring contiguous continuations (`_greedy_match`) — an approximation
of METEOR's chunk-minimizing beam alignment that agrees with it except on
pathological repeated-word ties. Segment scores take the max over
references; the corpus score is the mean over segments. Because the
synonym/paraphrase stages are absent, scores are a slight *underestimate*
of METEOR-1.5 on captions with synonymous rewordings — this is documented
rather than faked.

The Porter stemmer below is a from-spec implementation of Porter (1980),
"An algorithm for suffix stripping".
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

__all__ = ["porter_stem", "meteor_sentence", "meteor_corpus"]


# ---------------------------------------------------------------------------
# Porter stemmer (Porter 1980). Words are assumed lowercase.
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences in `stem` ([C](VC)^m[V])."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    """*o condition: stem ends cvc where the final c is not w, x or y."""
    if len(word) < 3:
        return False
    if not (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)):
        return False
    return word[-1] not in "wxy"


def _replace_if(word: str, suffix: str, repl: str, min_m: int):
    """If word ends with suffix and measure(stem) > min_m-?: Porter uses
    (m > k); here min_m is that k. Returns (new_word, True) on rule fire."""
    if word.endswith(suffix):
        stem = word[: len(word) - len(suffix)]
        if _measure(stem) > min_m:
            return stem + repl, True
        return word, True  # suffix matched: rule consumed, no change
    return word, False


def porter_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag_1b = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _ends_cvc(w):
            w += "e"

    # Step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2 (m > 0)
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
        ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
        ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
        ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
        ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
        ("biliti", "ble"),
    ]
    for suf, repl in step2:
        w, fired = _replace_if(w, suf, repl, 0)
        if fired:
            break

    # Step 3 (m > 0)
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, repl in step3:
        w, fired = _replace_if(w, suf, repl, 0)
        if fired:
            break

    # Step 4 (m > 1)
    step4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant",
             "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
             "ive", "ize"]
    # longest-match-first among the step-4 suffixes
    for suf in sorted(step4, key=len, reverse=True):
        if w.endswith(suf):
            if _measure(w[: len(w) - len(suf)]) > 1:
                w = w[: len(w) - len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st":
            if _measure(w[:-3]) > 1:
                w = w[:-3]

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            w = stem

    # Step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w


# ---------------------------------------------------------------------------
# METEOR alignment + score
# ---------------------------------------------------------------------------


def _greedy_match(hyp_items: List[Tuple[int, str]],
                  ref_items: List[Tuple[int, str]]):
    """Left-to-right 1-1 matching of equal strings, preferring the ref
    position that CONTINUES the previous match (prev_ref + 1) so repeated
    words don't fragment the alignment into spurious chunks — e.g. ref
    "b a b" / hyp "a b" aligns b->b at index 2 (one chunk), not index 0.
    This approximates METEOR's chunk-minimizing beam alignment with a
    single pass.

    Returns (matches [(hyp_idx, ref_idx)], hyp_leftover, ref_leftover)."""
    matches = []
    ref_used = [False] * len(ref_items)
    hyp_left = []
    prev_ref = None
    for hi, hw in hyp_items:
        cands = [j for j, (ri, rw) in enumerate(ref_items)
                 if not ref_used[j] and hw == rw]
        if not cands:
            hyp_left.append((hi, hw))
            continue
        j = next((j for j in cands
                  if prev_ref is not None
                  and ref_items[j][0] == prev_ref + 1), cands[0])
        ri = ref_items[j][0]
        matches.append((hi, ri))
        ref_used[j] = True
        prev_ref = ri
    ref_left = [it for j, it in enumerate(ref_items) if not ref_used[j]]
    return matches, hyp_left, ref_left


def _align(hyp: Sequence[str], ref: Sequence[str]):
    """Two-stage alignment: exact, then Porter stems on the leftovers."""
    hyp_items = list(enumerate(hyp))
    ref_items = list(enumerate(ref))
    exact, hyp_items, ref_items = _greedy_match(hyp_items, ref_items)
    hyp_stems = [(i, porter_stem(w)) for i, w in hyp_items]
    ref_stems = [(i, porter_stem(w)) for i, w in ref_items]
    stem, _, _ = _greedy_match(hyp_stems, ref_stems)
    return sorted(exact + stem)


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    """Fewest contiguous (in both hyp and ref order) runs covering the
    alignment; `matches` sorted by hypothesis index."""
    if not matches:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(matches, matches[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def meteor_sentence(refs: Sequence[str], hyp: str, *, alpha: float = 0.9,
                    beta: float = 3.0, gamma: float = 0.5) -> float:
    """METEOR for one hypothesis against one or more references (max)."""
    h = hyp.lower().split()
    best = 0.0
    for ref in refs:
        r = ref.lower().split()
        matches = _align(h, r)
        m = len(matches)
        if m == 0 or not h or not r:
            continue
        precision = m / len(h)
        recall = m / len(r)
        fmean = (precision * recall
                 / (alpha * precision + (1 - alpha) * recall))
        penalty = gamma * (_count_chunks(matches) / m) ** beta
        best = max(best, fmean * (1.0 - penalty))
    return best


def meteor_corpus(gts: Dict[str, List[str]], res: Dict[str, str],
                  **kw) -> float:
    """Mean segment METEOR over the corpus (pycocoevalcap convention of
    one aggregate scalar; see module docstring for stage caveats)."""
    if not res:
        return 0.0
    return sum(meteor_sentence(gts[k], hyp, **kw)
               for k, hyp in res.items()) / len(res)
