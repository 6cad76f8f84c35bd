"""Penn-Treebank-style caption tokenization (pure python, deterministic).

Copy of `grove_tpu/evals/ptb.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

The reference pipes every caption through pycocoevalcap's PTBTokenizer
before computing BLEU/METEOR/ROUGE/CIDEr (`eval_iground.py:461-468`):
that wrapper shells out to Stanford CoreNLP's
`edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase`
(ptb3Escaping on) and then REMOVES tokens from a fixed punctuation list.
No Java exists in this environment, but the PTB3 tokenization rules are
deterministic and published (Treebank tokenizer.sed + Stanford PTBLexer
conventions), so this module re-implements the pipeline:

  ptb_tokenize(text)   — PTB3 token stream, lowercased:
      * directional quote escaping:  "a" -> `` a ''
      * bracket escaping:            ( ) [ ] { } -> -LRB- -RRB- -LSB- ...
      * ellipsis:                    ... -> one token
      * commas/colons split unless between digits (5,000 / 5:30 intact)
      * sentence-final ? ! . split; abbreviation/acronym/number periods
        kept attached (etc. / u.s. / 3.5)
      * dashes: -- split, hyphenated words intact
      * contraction clitics split:   don't -> do n't, she's -> she 's,
        they'll -> they 'll, dogs' -> dogs '
      * Treebank special forms:      cannot -> can not, gonna -> gon na,
        gotta/wanna/lemme/gimme, 'tis -> 't is (Stanford FAQ-documented)
      * $ and % separated from numbers

  pycoco_tokenize(text) — ptb_tokenize + pycocoevalcap's punctuation-token
      removal (its PUNCTUATIONS list, verbatim), i.e. exactly what reaches
      the metric scorers in the reference.

Residual (documented) divergences from the Stanford jar, none of which a
typical generated caption exercises: unicode-punctuation normalization
(curly quotes, em-dashes), the `americanize` spelling map
(colour -> color), and escapes for `*` / `/` (ptb3Escaping's -STAR-
forms). See DEVIATIONS.md "Tokenization".
"""

from __future__ import annotations

import re
from typing import List

# pycocoevalcap tokenizer/ptbtokenizer.py PUNCTUATIONS, verbatim
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "[": "-LSB-", "]": "-RSB-",
             "{": "-LCB-", "}": "-RCB-"}

# Treebank "SREDAUX" special forms the Stanford tokenizer splits
# (case-insensitive; input is lowercased first)
_SPECIAL_FORMS = {
    "cannot": ["can", "not"],
    "gonna": ["gon", "na"],
    "gotta": ["got", "ta"],
    "wanna": ["wan", "na"],
    "lemme": ["lem", "me"],
    "gimme": ["gim", "me"],
    "'tis": ["'t", "is"],
    "'twas": ["'t", "was"],
}

# words whose trailing period stays attached (PTB abbreviation behavior);
# compact list covering caption-plausible cases
_ABBREVS = frozenset([
    "mr.", "mrs.", "ms.", "dr.", "prof.", "st.", "jr.", "sr.", "vs.",
    "etc.", "e.g.", "i.e.", "inc.", "ltd.", "co.", "corp.", "dept.",
    "fig.", "no.", "vol.", "al.", "approx.", "est.", "min.", "max.",
    "oz.", "lb.", "lbs.", "tbsp.", "tsp.", "ft.", "in.", "sq.",
    "jan.", "feb.", "mar.", "apr.", "jun.", "jul.", "aug.", "sep.",
    "sept.", "oct.", "nov.", "dec.", "mon.", "tue.", "wed.", "thu.",
    "fri.", "sat.", "sun.",
])

_CLITICS = re.compile(r"(?<=\w)(n't|'ll|'re|'ve|'d|'s|'m)$")


def _split_trailing_punct(tok: str) -> List[str]:
    """Peel sentence-final ?/!/. and trailing quotes/brackets off a token."""
    out: List[str] = []
    while tok:
        if tok in _ABBREVS:
            break
        last = tok[-1]
        if last in "?!":
            out.append(last)
            tok = tok[:-1]
            continue
        if last in ")]}":
            out.append(_BRACKETS[last])
            tok = tok[:-1]
            continue
        if tok.endswith("..."):
            out.append("...")
            tok = tok[:-3]
            continue
        if last == "." and len(tok) > 1:
            core = tok[:-1]
            # keep the period on acronyms (u.s.), decimals (3.5), and
            # single letters (middle initials)
            if "." in core or len(core) == 1:
                break
            out.append(".")
            tok = core
            continue
        if last in ",;:":
            out.append(last)
            tok = tok[:-1]
            continue
        if last == "'" and len(tok) > 1 and tok[-2] != "'":
            # plural possessive (dogs') or close-quote
            out.append("'")
            tok = tok[:-1]
            continue
        break
    if tok:
        out.append(tok)
    return out[::-1]


def _split_leading_punct(tok: str) -> List[str]:
    out: List[str] = []
    while tok:
        first = tok[0]
        if first in "([{":
            out.append(_BRACKETS[first])
            tok = tok[1:]
            continue
        if first == "'" and len(tok) > 1 and not (
                tok in _SPECIAL_FORMS or _CLITICS.search(tok)
                or tok.startswith("'t")):
            out.append("`")
            tok = tok[1:]
            continue
        break
    if tok:
        out.append(tok)
    return out


def _split_word(tok: str) -> List[str]:
    """Inner splits on an already punct-peeled word token."""
    if tok in _SPECIAL_FORMS:
        return list(_SPECIAL_FORMS[tok])
    m = _CLITICS.search(tok)
    if m and m.start() > 0:
        head = tok[:m.start()]
        return _split_word(head) + [m.group(0)]
    # $/# prefix off numbers: $400 -> $ 400
    if len(tok) > 1 and tok[0] in "$#":
        return [tok[0]] + _split_word(tok[1:])
    # % suffix: 40% -> 40 %
    if len(tok) > 1 and tok.endswith("%"):
        return _split_word(tok[:-1]) + ["%"]
    return [tok]


_COMMA_NONNUM = re.compile(r",(?!\d)")
_NUM_COMMA = re.compile(r"(?<!\d),")
_COLON_NONNUM = re.compile(r"(?<!\d):|:(?!\d)")
_DASHES = re.compile(r"--+")
_ELLIPSIS_MID = re.compile(r"\.\.\.(?=.)")


_OPEN_QUOTE = re.compile(r'(^|[\s(\[{])"')


def ptb_tokenize(text: str) -> List[str]:
    """PTB3-style tokens of `text`, lowercased (-preserveLines -lowerCase)."""
    s = text.lower().replace("\n", " ")
    # directional double quotes BEFORE any other splitting (direction
    # depends on the original context): opening after start/space/open
    # bracket, closing otherwise
    s = _OPEN_QUOTE.sub(lambda m: m.group(1) + " `` ", s)
    s = s.replace('"', " '' ")
    # separate em-dash runs and mid-string ellipses with spaces first
    s = _DASHES.sub(lambda m: " -- ", s)
    s = _ELLIPSIS_MID.sub(" ... ", s)
    # commas/colons not between digits become their own tokens
    s = _COMMA_NONNUM.sub(" , ", s)
    s = _NUM_COMMA.sub(" , ", s)
    s = _COLON_NONNUM.sub(" : ", s)
    toks: List[str] = []
    for raw in s.split():
        if raw in PUNCTUATIONS or raw in _BRACKETS.values():
            toks.append(raw)
            continue
        for t1 in _split_leading_punct(raw):
            if t1 in PUNCTUATIONS or t1 in _BRACKETS.values():
                toks.append(t1)
                continue
            for t2 in _split_trailing_punct(t1):
                if t2 in PUNCTUATIONS or t2 in _BRACKETS.values():
                    toks.append(t2)
                else:
                    toks.extend(_split_word(t2))
    return toks


def pycoco_tokenize(text: str) -> List[str]:
    """ptb_tokenize + pycocoevalcap's punctuation removal: the token
    stream that reaches BLEU/ROUGE/CIDEr/METEOR in the reference."""
    return [t for t in ptb_tokenize(text) if t not in PUNCTUATIONS]
