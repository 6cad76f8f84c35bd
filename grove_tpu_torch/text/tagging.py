"""Grounded-caption tagging: build and parse `<p> phrase </p> [DET]` markup.

A copy of `grove_tpu/text/tagging.py`, so that the port imports nothing of the JAX
package; `tests/test_torch_misc.py` holds the two equal.

The GROVE output protocol wraps each grounded noun phrase in <p>…</p>
followed by a [DET] token. Builders mirror the dataset side
(`dataset/video_grounding_datasets/HowTo100M.py:180-199`), parsers mirror the
inference side (`infer_iground.py:202-240`).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

from .constants import BOP_TOKEN, DET_TOKEN, EOP_TOKEN

_PHRASE_RE = re.compile(r"<p>(.*?)<\/p>")
_ANY_TAG_RE = re.compile(r"<.*?>")


def tag_caption(caption: str, spans: Sequence[Tuple[int, int]]) -> str:
    """Wrap each (start, end) character span of `caption` in tags + [DET].

    Spans must be non-overlapping; they are processed right-to-left so the
    earlier offsets stay valid.
    """
    out = caption
    for start, end in sorted(spans, key=lambda s: -s[0]):
        out = (out[:start] + f"{BOP_TOKEN} {out[start:end]} {EOP_TOKEN} "
               + DET_TOKEN + out[end:])
    return out


def extract_phrases(text: str) -> List[str]:
    """All `<p>…</p>` phrase strings, stripped (`infer_iground.py:208-210`)."""
    return [p.strip() for p in _PHRASE_RE.findall(text)]


def strip_tags(text: str) -> str:
    """Caption with all tags and [DET] removed, whitespace normalized.

    Follows `infer_iground.py:206,221-227`: remove `<...>` tags, drop [DET],
    collapse whitespace, strip quotes.
    """
    cleaned = _ANY_TAG_RE.sub("", text)
    cleaned = cleaned.replace(DET_TOKEN, "")
    cleaned = " ".join(cleaned.split()).strip("'").strip()
    return cleaned


def strip_det_only(text: str) -> str:
    """Caption keeping <p>…</p> tags but removing [DET] tokens.

    Follows `infer_iground.py:229-232` (`pred_text_tagged`).
    """
    cleaned = text.replace(DET_TOKEN, "")
    return " ".join(cleaned.split()).strip("'").strip()


def repair_generation(text: str) -> str:
    """Generic repair of malformed grounded-caption markup.

    The reference patches specific malformed ANet generations by hand
    (`infer_anet.py:194-213`, a table of literal string replacements tied to
    its checkpoint). Those fix-ups encode two malformation classes, which we
    repair generically instead:

      1. an orphan ``</p>`` with no opening ``<p>`` — the phrase words since
         the previous ``[DET]`` (or segment start) get an inserted ``<p>``;
      2. a bare ``[DET]`` not preceded by a ``<p>…</p>`` phrase — a
         placeholder ``<p> object </p>`` is inserted (matching the
         reference's choice of the word "object" for unattributable dets).

    Well-formed text passes through unchanged.
    """
    toks = text.split(" ")
    out: List[str] = []
    open_idx = None          # index in `out` of the pending "<p>"
    closed_since_det = False  # a full <p>..</p> seen since the last [DET]
    for tk in toks:
        if tk == BOP_TOKEN:
            if open_idx is not None:
                # nested open: drop the earlier unclosed one
                out.pop(open_idx)
            out.append(tk)
            open_idx = len(out) - 1
        elif tk == EOP_TOKEN:
            if open_idx is None:
                # orphan close: open the phrase after the previous [DET]
                start = len(out)
                for j in range(len(out) - 1, -1, -1):
                    if out[j] in (DET_TOKEN, EOP_TOKEN):
                        break
                    start = j
                out.insert(start, BOP_TOKEN)
            out.append(tk)
            open_idx = None
            closed_since_det = True
        elif tk == DET_TOKEN:
            if open_idx is not None:
                # det inside an open phrase: close it first
                out.append(EOP_TOKEN)
                open_idx = None
                closed_since_det = True
            if not closed_since_det:
                out.extend([BOP_TOKEN, "object", EOP_TOKEN])
            out.append(tk)
            closed_since_det = False
        else:
            out.append(tk)
    if open_idx is not None:
        out.pop(open_idx)   # trailing unclosed <p>: drop the tag
    return " ".join(t for t in out if t)


def parse_generation(text_output: str) -> dict:
    """Post-process a raw decoded generation into the public output fields.

    Returns {"text", "text_tagged", "phrases"} exactly as the reference
    inference drivers compute them (`infer_iground.py:202-232`).
    """
    text_output = text_output.replace("\n", "").replace("  ", " ")
    text_output = text_output.split("ASSISTANT: ")[-1]
    return {
        "text": strip_tags(text_output),
        "text_tagged": strip_det_only(text_output),
        "phrases": extract_phrases(text_output),
    }
