"""Rule-based English lemmatizer for ANet-Entities class matching.

Copy of `grove_tpu/evals/lemma.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

The reference shells out to Stanford CoreNLP for lemmatization
(`eval_anet.py` imports the server-backed lemmatizer); no Java exists in
this environment, so this module approximates the noun/verb lemma classes
CoreNLP produces for the object-class vocabulary the metric compares:

  * an irregular table for the common noun plurals and verb forms that
    appear in everyday object/action vocabulary;
  * morphological rules with the standard orthographic repairs
    (-ies -> -y, -ves -> -f/-fe, -es after sibilants, consonant
    de-doubling and e-restoration for -ing/-ed).

Deterministic, no external assets; identical to CoreNLP on regular
inflections and the tabled irregulars (see evals/DEVIATIONS.md for the
residual gap on out-of-table irregulars).
"""

from __future__ import annotations

IRREGULAR = {
    # nouns
    "children": "child", "men": "man", "women": "woman",
    "people": "person", "feet": "foot", "teeth": "tooth",
    "mice": "mouse", "geese": "goose", "oxen": "ox", "dice": "die",
    "knives": "knife", "wives": "wife", "lives": "life",
    "leaves": "leaf", "loaves": "loaf", "shelves": "shelf",
    "wolves": "wolf", "halves": "half", "calves": "calf",
    "scarves": "scarf", "thieves": "thief", "hooves": "hoof",
    "glasses": "glass", "dishes": "dish", "boxes": "box",
    "potatoes": "potato", "tomatoes": "tomato", "heroes": "hero",
    "echoes": "echo", "pianos": "piano", "photos": "photo",
    "videos": "video", "radios": "radio", "zoos": "zoo",
    "scissors": "scissors", "pants": "pants", "shorts": "shorts",
    "clothes": "clothes", "series": "series", "species": "species",
    "fish": "fish", "sheep": "sheep", "deer": "deer",
    # verbs (past/participle/3sg that class phrases occasionally carry)
    "went": "go", "goes": "go", "gone": "go", "ran": "run",
    "running": "run", "made": "make", "making": "make",
    "took": "take", "taken": "take", "taking": "take",
    "held": "hold", "holding": "hold", "put": "put", "cut": "cut",
    "cutting": "cut", "sat": "sit", "sitting": "sit",
    "stood": "stand", "standing": "stand", "got": "get",
    "getting": "get", "gave": "give", "given": "give",
    "giving": "give", "came": "come", "coming": "come",
    "said": "say", "says": "say", "saw": "see", "seen": "see",
    "did": "do", "does": "do", "done": "do", "ate": "eat",
    "eaten": "eat", "eating": "eat", "drank": "drink",
    "drunk": "drink", "wrote": "write", "written": "write",
    "writing": "write", "left": "leave", "leaving": "leave",
    "bought": "buy", "brought": "bring", "thought": "think",
    "caught": "catch", "taught": "teach", "built": "build",
    "broke": "break", "broken": "break", "chose": "choose",
    "chosen": "choose", "drove": "drive", "driven": "drive",
    "driving": "drive", "fell": "fall", "fallen": "fall",
    "flew": "fly", "flown": "fly", "grew": "grow", "grown": "grow",
    "knew": "know", "known": "know", "lay": "lie", "lain": "lie",
    "lying": "lie", "rode": "ride", "ridden": "ride",
    "riding": "ride", "rose": "rise", "risen": "rise",
    "sang": "sing", "sung": "sing", "spoke": "speak",
    "spoken": "speak", "swam": "swim", "swum": "swim",
    "swimming": "swim", "threw": "throw", "thrown": "throw",
    "wore": "wear", "worn": "wear", "won": "win", "winning": "win",
    "using": "use", "used": "use", "uses": "use",
}

VOWELS = set("aeiou")
SIBILANT_ES = ("ches", "shes", "sses", "xes", "zes")


def _restore_e(stem: str) -> str:
    """mak -> make, slic -> slice: restore the silent e after stripping
    -ing/-ed when the stem ends consonant + single vowel + consonant is
    NOT the right cue; the reliable cue is stems ending in c/g/s/v/z or
    consonant+l/r (danc+e, juggl+e). Conservative: only endings where
    bare stems are not valid words themselves."""
    if not stem:
        return stem
    if stem.endswith(("c", "v", "z", "u", "g")):
        # slice, move, freeze, argue, charge — but not "sing"/"hang"
        if stem.endswith("g") and len(stem) > 2 \
                and stem[-2] in ("n", "o"):   # sing, song-ish stems
            return stem
        return stem + "e"
    if len(stem) >= 2 and stem[-1] in ("l", "r") \
            and stem[-2] not in VOWELS and stem[-2] not in ("l", "r"):
        return stem + "e"                      # juggle, wriggle, sparkle
    return stem


def english_lemma(word: str) -> str:
    """Lowercased single-token lemma (nouns + common verbs)."""
    w = word.lower().strip()
    if not w:
        return w
    if w in IRREGULAR:
        return IRREGULAR[w]

    # plural / 3sg endings
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"                    # babies -> baby
    if w.endswith("ves") and len(w) > 4:
        # default: plural of a regular -ve word (gloves -> glove,
        # waves -> wave); the f/fe irregulars (knives, leaves, ...) are
        # all in the table above — a blanket -ves -> -f rule would
        # corrupt every regular -ve word
        return w[:-1]
    for suf in SIBILANT_ES:
        if w.endswith(suf) and len(w) > len(suf) + 1:
            return w[:-2]                      # dishes -> dish
    if w.endswith("oes") and len(w) > 4:
        return w[:-2]                          # potatoes handled above
    if w.endswith("s") and not w.endswith(("ss", "us", "is")) \
            and len(w) > 3:
        return w[:-1]                          # cups -> cup

    # progressive / past endings
    for suf in ("ing", "ed"):
        if w.endswith(suf) and len(w) > len(suf) + 2:
            stem = w[: -len(suf)]
            if len(stem) >= 3 and stem[-1] == stem[-2] \
                    and stem[-1] not in VOWELS and stem[-1] not in "lsz":
                return stem[:-1]               # stopped -> stop
            return _restore_e(stem)            # slicing -> slice
    return w
