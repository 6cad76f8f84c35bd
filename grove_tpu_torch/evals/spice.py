"""SPICE-style semantic caption metric from a rule-based scene graph.

Copy of `grove_tpu/evals/spice.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

The reference scores captions with SPICE via pycocoevalcap's Java
pipeline (`eval_iground.py:461-468`): Stanford CoreNLP dependency-parses
each caption, converts the parse to a scene graph of objects /
attributes / relations (Anderson et al., "SPICE: Semantic Propositional
Image Caption Evaluation", ECCV 2016), and reports the F1 between the
candidate's tuple set and the union of the references' tuple sets.

No Java/CoreNLP exists in this environment, so this module implements
the same TUPLE-F1 METRIC over a scene graph produced by a deterministic
rule-based shallow parser instead of a dependency parser:

  * closed-class lexicons (determiners, prepositions, auxiliaries,
    pronouns, conjunctions) + a verb detector built on the
    irregular-verb table in `evals/lemma.py` and -ing/-ed/-s
    morphology + an adjective detector (common-word list, colors,
    -ful/-ous/-ive/... suffixes);
  * noun-phrase chunking: maximal [DET] [ADV]* [ADJ]* NOUN+ spans,
    head = final noun, attributes = adjectives and pre-head noun
    modifiers (CoreNLP's amod/nn edges);
  * relations between consecutive noun phrases from the connective
    span: verb groups yield (head1, verb_lemma[+prep], head2), bare
    prepositions yield (head1, prep, head2) — the clausal and
    prepositional edges that dominate grounded-caption scene graphs.

Deviations from the jar (documented in evals/DEVIATIONS.md): no WordNet
synset matching (tuples match on exact lemmas only) and a shallow parse
instead of a full dependency parse, so absolute values are NOT
comparable to published SPICE numbers. Results are therefore keyed
"SPICE_rule"; the plain "SPICE" key stays None, never faked.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Set, Tuple

from .lemma import english_lemma

DETERMINERS = {
    "a", "an", "the", "this", "that", "these", "those", "his", "her",
    "its", "their", "our", "my", "your", "some", "any", "each", "every",
    "no", "both", "few", "several", "many", "most", "all", "another",
    "other", "one", "two", "three", "four", "five", "six", "seven",
    "eight", "nine", "ten",
}
PREPOSITIONS = {
    "in", "on", "at", "with", "by", "from", "to", "into", "onto",
    "over", "under", "above", "below", "behind", "beside", "between",
    "near", "next", "of", "off", "through", "against", "around",
    "across", "along", "inside", "outside", "toward", "towards",
    "up", "down", "out", "within", "atop", "underneath", "beneath",
}
AUXILIARIES = {
    "is", "are", "was", "were", "be", "been", "being", "am",
    "has", "have", "had", "having", "do", "does", "did",
    "will", "would", "shall", "should", "can", "could", "may",
    "might", "must",
}
PRONOUNS = {
    "he", "she", "it", "they", "we", "i", "you", "him", "them", "us",
    "me", "her", "his", "hers", "theirs", "who", "which", "there",
    "something", "someone", "anything", "everything",
}
CONJUNCTIONS = {"and", "or", "but", "while", "as", "then", "when",
                "where", "so", "because", "if", "that"}
NEGATIONS = {"not", "n't", "never"}

# Common adjectives in grounded video/image captions (colors, sizes,
# materials, ages, shapes, states) — the open-class part of the tagger.
ADJECTIVES = {
    "red", "orange", "yellow", "green", "blue", "purple", "pink",
    "brown", "black", "white", "gray", "grey", "golden", "silver",
    "dark", "light", "bright", "colorful", "big", "large", "huge",
    "small", "little", "tiny", "tall", "short", "long", "wide",
    "narrow", "thick", "thin", "round", "square", "flat", "deep",
    "shallow", "young", "old", "new", "fresh", "dry", "wet", "hot",
    "cold", "warm", "cool", "clean", "dirty", "empty", "full", "open",
    "closed", "wooden", "metal", "plastic", "glass", "paper", "leather",
    "ceramic", "left", "right", "front", "back", "top", "bottom",
    "middle", "upper", "lower", "first", "second", "third", "last",
    "fast", "slow", "quick", "busy", "happy", "sad", "beautiful",
    "pretty", "nice", "good", "bad", "soft", "hard", "heavy", "sharp",
    "dull", "smooth", "rough", "shiny", "striped", "checkered",
    "patterned", "plain", "bald", "blonde", "elderly", "male", "female",
}
ADJ_SUFFIXES = ("ful", "ous", "ive", "able", "ible", "less", "ish",
                "ian", "ary", "ical")

# Common verbs whose base forms would otherwise default to NOUN.
COMMON_VERBS = {
    "cut", "cuts", "hold", "holds", "put", "puts", "place", "places",
    "pour", "pours", "mix", "mixes", "stir", "stirs", "add", "adds",
    "remove", "removes", "wash", "washes", "slice", "slices", "chop",
    "chops", "peel", "peels", "cook", "cooks", "fry", "fries", "bake",
    "bakes", "grill", "grills", "boil", "boils", "serve", "serves",
    "walk", "walks", "run", "runs", "jump", "jumps", "stand", "stands",
    "sit", "sits", "lie", "lies", "wear", "wears", "carry", "carries",
    "throw", "throws", "catch", "catches", "kick", "kicks", "hit",
    "hits", "push", "pushes", "pull", "pulls", "open", "opens",
    "close", "closes", "move", "moves", "turn", "turns", "look",
    "looks", "watch", "watches", "talk", "talks", "speak", "speaks",
    "play", "plays", "ride", "rides", "drive", "drives", "use", "uses",
    "make", "makes", "take", "takes", "give", "gives", "show", "shows",
    "point", "points", "touch", "touches", "grab", "grabs", "lift",
    "lifts", "drop", "drops", "wipe", "wipes", "spread", "spreads",
    "sprinkle", "sprinkles", "squeeze", "squeezes", "flip", "flips",
    "season", "seasons", "eat", "eats", "drink", "drinks",
}

_WORD_RE = re.compile(r"[a-z']+")


def _tokenize(caption: str) -> List[str]:
    return _WORD_RE.findall(caption.lower())


def _is_verb(tok: str) -> bool:
    if tok in AUXILIARIES:
        return False
    if tok in COMMON_VERBS:
        return True
    lemma = english_lemma(tok)
    if lemma != tok and (lemma in COMMON_VERBS
                         or tok.endswith(("ing", "ed"))):
        return True
    return tok.endswith("ing") and len(tok) > 4


def _is_adjective(tok: str) -> bool:
    return tok in ADJECTIVES or tok.endswith(ADJ_SUFFIXES)


def pos_tags(tokens: Sequence[str]) -> List[str]:
    """Shallow tagger: DET / PREP / AUX / PRON / CONJ / NEG / ADV /
    VERB / ADJ / NOUN (default)."""
    tags = []
    for i, tok in enumerate(tokens):
        if tok in DETERMINERS:
            tags.append("DET")
        elif tok in PREPOSITIONS:
            tags.append("PREP")
        elif tok in AUXILIARIES:
            tags.append("AUX")
        elif tok in PRONOUNS:
            tags.append("PRON")
        elif tok in CONJUNCTIONS:
            tags.append("CONJ")
        elif tok in NEGATIONS:
            tags.append("NEG")
        elif tok.endswith("ly") and len(tok) > 3:
            tags.append("ADV")
        elif _is_adjective(tok):
            # participles ("cutting board") are nouns-modifiers when a
            # noun follows; the chunker handles that via pre-head nouns
            tags.append("ADJ")
        elif _is_verb(tok):
            tags.append("VERB")
        else:
            tags.append("NOUN")
    return tags


def scene_graph(caption: str) -> Tuple[Set[Tuple[str, ...]],
                                       Set[Tuple[str, ...]],
                                       Set[Tuple[str, ...]]]:
    """caption -> (objects {(o,)}, attributes {(o, a)},
    relations {(s, rel, o)}) with lemmatized entries."""
    tokens = _tokenize(caption)
    tags = pos_tags(tokens)

    # --- chunk noun phrases: [DET] [ADV]* [ADJ]* NOUN+ ---
    phrases = []          # (head_lemma, [attr lemmas], start, end)
    i = 0
    n = len(tokens)
    while i < n:
        j = i
        has_det = j < n and tags[j] == "DET"
        if has_det:
            j += 1
        adjs = []
        while j < n:
            if tags[j] == "ADJ":
                adjs.append(english_lemma(tokens[j]))
            elif tags[j] == "ADV":
                pass
            elif (tags[j] == "VERB" and has_det and j + 1 < n
                  and tags[j + 1] in ("NOUN", "ADJ")):
                # participial modifier inside a determiner-opened NP:
                # "the cutting board", "a sliced onion" (CoreNLP amod)
                adjs.append(english_lemma(tokens[j]))
            else:
                break
            j += 1
        nouns = []
        while j < n and tags[j] == "NOUN":
            nouns.append(english_lemma(tokens[j]))
            j += 1
        if nouns:
            head = nouns[-1]
            attrs = adjs + nouns[:-1]     # pre-head nouns: nn modifiers
            phrases.append((head, attrs, i, j))
            i = j
        else:
            i = max(j, i + 1)

    objects = {(p[0],) for p in phrases}
    attributes = {(p[0], a) for p in phrases for a in p[1]}

    # --- relations from the connective span between consecutive NPs ---
    relations = set()
    for (h1, _, _, e1), (h2, _, s2, _) in zip(phrases, phrases[1:]):
        between = [(tokens[k], tags[k]) for k in range(e1, s2)]
        if any(t == "CONJ" for _, t in between):
            continue                      # clause/list boundary
        verbs = [english_lemma(w) for w, t in between if t == "VERB"]
        preps = [w for w, t in between if t == "PREP"]
        if verbs:
            # first verb: later verbs in the span are usually
            # participial modifiers absorbed by the next NP's parse
            rel = verbs[0] + (f"_{preps[-1]}" if preps else "")
            relations.add((h1, rel, h2))
        elif preps:
            relations.add((h1, preps[-1], h2))
    return objects, attributes, relations


def _tuples(caption: str) -> Set[Tuple[str, ...]]:
    o, a, r = scene_graph(caption)
    return o | a | r


def spice_rule(gts: Dict[str, List[str]], res: Dict[str, str]) -> float:
    """Mean tuple-F1 over the corpus (SPICE's aggregation: per-caption
    F1 against the union of the references' tuples, averaged)."""
    scores = []
    for key, hyp in res.items():
        cand = _tuples(hyp)
        ref: Set[Tuple[str, ...]] = set()
        for r in gts[key]:
            ref |= _tuples(r)
        if not cand and not ref:
            scores.append(1.0)
            continue
        matched = len(cand & ref)
        p = matched / len(cand) if cand else 0.0
        rcl = matched / len(ref) if ref else 0.0
        scores.append(2 * p * rcl / (p + rcl) if p + rcl > 0 else 0.0)
    return sum(scores) / len(scores) if scores else 0.0
