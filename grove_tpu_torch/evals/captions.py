"""Caption metrics in pure python: BLEU-1..4, ROUGE-L, CIDEr-D.

Copy of `grove_tpu/evals/captions.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

This environment has no pycocoevalcap/Java, so the metrics the reference
computes via pycocoevalcap (`eval_iground.py:461-468`) are re-implemented
from their definitions:
  * BLEU: corpus-level, uniform n-gram weights, closest-ref brevity penalty
    (pycocoevalcap's Bleu scorer semantics);
  * ROUGE-L: LCS F-score with beta = 1.2, max over refs, mean over corpus;
  * CIDEr-D: n = 1..4 TF-IDF cosine with length gaussian (sigma = 6) and
    count clipping, x10 scale.

METEOR is computed by `evals/meteor.py` — a from-spec pure-python
implementation with the asset-free exact + Porter-stem matcher stages (the
jar's WordNet/paraphrase stages need external DBs; see that module's
docstring for the documented deviation). SPICE requires a Java CoreNLP
scene-graph parser; it is intentionally not faked — callers get an
explicit None.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

from .meteor import meteor_corpus


def _tokens(s: str) -> List[str]:
    return s.lower().split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(gts: Dict[str, List[str]], res: Dict[str, str],
         max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n. gts: id -> list of refs; res: id -> hypothesis."""
    clipped = [0.0] * max_n
    totals = [0.0] * max_n
    hyp_len = 0
    ref_len = 0
    for key, hyp in res.items():
        h = _tokens(hyp)
        refs = [_tokens(r) for r in gts[key]]
        hyp_len += len(h)
        # closest reference length
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hng = _ngrams(h, n)
            max_ref = Counter()
            for r in refs:
                rng = _ngrams(r, n)
                for g, c in rng.items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += max(len(h) - n + 1, 0)
            clipped[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in hng.items())
    # pycocoevalcap BleuScorer arithmetic, verbatim: cumulative product of
    # smoothed precisions ((correct+tiny)/(guess+small)), k-th root, brevity
    # penalty exp(1-1/ratio) applied only when ratio < 1. The tiny/small
    # constants make zero-count orders reproducible to machine precision.
    tiny, small = 1e-15, 1e-9
    scores = []
    prod = 1.0
    for n in range(1, max_n + 1):
        prod *= (clipped[n - 1] + tiny) / (totals[n - 1] + small)
        scores.append(prod ** (1.0 / n))
    ratio = (hyp_len + tiny) / (ref_len + small)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        scores = [s * bp for s in scores]
    return scores


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


def rouge_l(gts: Dict[str, List[str]], res: Dict[str, str],
            beta: float = 1.2) -> float:
    """pycocoevalcap Rouge convention: the F-score combines the max
    PRECISION over refs with the max RECALL over refs taken SEPARATELY
    (possibly from different refs) — not the max per-ref F."""
    scores = []
    for key, hyp in res.items():
        h = _tokens(hyp)
        prec_max = 0.0
        rec_max = 0.0
        for ref in gts[key]:
            r = _tokens(ref)
            lcs = _lcs_len(h, r)
            if h:
                prec_max = max(prec_max, lcs / len(h))
            if r:
                rec_max = max(rec_max, lcs / len(r))
        if prec_max > 0 and rec_max > 0:
            f = ((1 + beta ** 2) * prec_max * rec_max
                 / (rec_max + beta ** 2 * prec_max))
        else:
            f = 0.0
        scores.append(f)
    return sum(scores) / len(scores) if scores else 0.0


def cider_d(gts: Dict[str, List[str]], res: Dict[str, str],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D (Vedantam et al. 2015), the pycocoevalcap variant."""
    # document frequencies over reference sets
    doc_freq = [defaultdict(int) for _ in range(max_n)]
    for key in gts:
        for n in range(max_n):
            seen = set()
            for ref in gts[key]:
                seen |= set(_ngrams(_tokens(ref), n + 1).keys())
            for g in seen:
                doc_freq[n][g] += 1
    num_docs = max(len(gts), 1)

    def tfidf_vec(tokens, n):
        cnt = _ngrams(tokens, n + 1)
        vec = {}
        norm = 0.0
        for g, c in cnt.items():
            df = math.log(max(doc_freq[n][g], 1.0))
            idf = math.log(num_docs) - df
            v = c * idf
            vec[g] = v
            norm += v * v
        return vec, math.sqrt(norm), sum(cnt.values())

    scores = []
    for key, hyp in res.items():
        h = _tokens(hyp)
        score_n = [0.0] * max_n
        for ref in gts[key]:
            r = _tokens(ref)
            for n in range(max_n):
                hv, hn, hl = tfidf_vec(h, n)
                rv, rn, rl = tfidf_vec(r, n)
                # clipped dot product
                dot = sum(min(hv[g], rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g in hv)
                if hn > 0 and rn > 0:
                    val = dot / (hn * rn)
                else:
                    val = 0.0
                delta = len(h) - len(r)
                val *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                score_n[n] += val
        nref = len(gts[key])
        scores.append(10.0 * sum(s / nref for s in score_n) / max_n)
    return sum(scores) / len(scores) if scores else 0.0


def caption_metrics(gts: Dict[str, List[str]], res: Dict[str, str],
                    ptb: bool = True) -> Dict:
    from .spice import spice_rule

    if ptb:
        # the reference tokenizes ONCE with PTBTokenizer (+ punctuation
        # removal) before every scorer (`eval_iground.py:461-468` via
        # pycocoevalcap); mirror that by rewriting the caption strings as
        # space-joined PTB tokens so all downstream whitespace splits see
        # the identical stream
        from .ptb import pycoco_tokenize
        gts = {k: [" ".join(pycoco_tokenize(r)) for r in v]
               for k, v in gts.items()}
        res = {k: " ".join(pycoco_tokenize(h)) for k, h in res.items()}

    b = bleu(gts, res)
    meteor = meteor_corpus(gts, res)
    return {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "ROUGE_L": rouge_l(gts, res),
        "CIDEr": cider_d(gts, res),
        # exact+stem stages only (no WordNet/paraphrase tables in this
        # env), so values systematically underestimate METEOR-1.5 jar
        # scores. Keyed by variant so they are never mistaken for (or
        # compared against) published METEOR numbers; the plain key is
        # kept as an alias with an explicit marker in "METEOR_variant".
        "METEOR": meteor,
        "METEOR_exact_stem": meteor,
        "METEOR_variant": "exact+stem (no WordNet/paraphrase; see meteor.py)",
        # the exact jar metric needs Java CoreNLP (dependency parse +
        # WordNet); the plain key stays None — never faked. SPICE_rule
        # is the same tuple-F1 over a rule-based scene graph
        # (evals/spice.py), useful for relative comparisons only.
        "SPICE": None,
        "SPICE_rule": spice_rule(gts, res),
        "SPICE_variant": ("rule-based scene graph, exact-lemma matching "
                          "(no CoreNLP/WordNet; see spice.py)"),
    }
