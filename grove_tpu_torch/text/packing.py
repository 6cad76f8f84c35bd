"""Ragged -> static sequence packing (host-side, numpy).

A copy of `grove_tpu/text/packing.py`, so that the port imports nothing of the JAX
package; `tests/test_torch_misc.py` holds the two equal.

This is the single biggest design delta from the reference: its model splices
576 video features into the token stream *inside* the forward pass with
dynamic list surgery (`llava_with_region_arch.py:127-440`) and builds det-token
masks with a hard-coded 575 offset (`model/GROVE.py:200-205`). Here all of
that is resolved on the host into fixed-shape arrays; the device-side model
only does a `dynamic_update_slice` of the video features at `video_start`.

A packed example contains:
  input_ids    (Ls,)  int32  spliced ids; video positions hold `video_fill_id`
  video_start  ()     int32  index of the first video token
  attn_mask    (Ls,)  bool   True on real (non-pad) positions
  labels       (Ls,)  int32  CE targets, IGNORE_INDEX on masked positions
  det_positions(P,)   int32  hidden-state gather index per phrase: the
                             position whose *next* token is [DET]
  phrase_mask  (P,)   bool   True for real phrases
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX
from .conversation import CONV_TEMPLATES
from .prompts import tokenize_with_video


@dataclass
class PackedText:
    input_ids: np.ndarray
    video_start: np.ndarray
    attn_mask: np.ndarray
    labels: np.ndarray
    det_positions: np.ndarray
    phrase_mask: np.ndarray
    length: int  # true spliced length (pre-padding)


def mask_conversation_targets(input_ids: Sequence[int], conversation: str,
                              tokenizer, template: str = "llava_v1",
                              has_video: bool = True) -> np.ndarray:
    """CE target masking over the *unspliced* token stream.

    Re-implements `dataset/dataset.py:73-99` (`_process_conversation`):
    instruction spans are IGNOREd per llava_v1 separators; answer spans
    (including the closing </s>) are kept.
    """
    conv = CONV_TEMPLATES[template]
    sep = conv.sep + conv.roles[1] + ": "
    sep2 = conv.sep2

    target = np.asarray(list(input_ids), dtype=np.int64).copy()
    rounds = conversation.split(sep2)
    cur_len = 1
    target[:cur_len] = IGNORE_INDEX
    for rou in rounds:
        if not rou:
            break
        parts = rou.split(sep)
        assert len(parts) == 2, (len(parts), rou)
        parts[0] += sep
        if has_video:
            round_len = len(tokenize_with_video(rou, tokenizer))
            instruction_len = len(tokenize_with_video(parts[0], tokenizer)) - 2
        else:
            round_len = len(tokenizer(rou).input_ids)
            instruction_len = len(tokenizer(parts[0]).input_ids) - 2
        target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len
    target[cur_len:] = IGNORE_INDEX
    return target


def splice_video_tokens(
    input_ids: Sequence[int],
    labels: Optional[Sequence[int]],
    num_video_tokens: int,
    video_fill_id: int = 0,
    video_token_index: int = VIDEO_TOKEN_INDEX,
):
    """Replace the single sentinel with `num_video_tokens` filler positions.

    Matches the splice of `llava_with_region_arch.py:254-291` (the
    mm_use_im_start_end config attr is never actually set in the reference, so
    the plain else-branch runs: sentinel -> N features, labels -> IGNORE).
    Returns (spliced_ids, spliced_labels, video_start).
    """
    ids = list(input_ids)
    try:
        pos = ids.index(video_token_index)
    except ValueError:
        pos = None
    if pos is None:
        out_ids = np.asarray(ids, dtype=np.int64)
        out_labels = (np.asarray(list(labels), dtype=np.int64)
                      if labels is not None else None)
        return out_ids, out_labels, -1
    out_ids = np.concatenate([
        np.asarray(ids[:pos], dtype=np.int64),
        np.full((num_video_tokens,), video_fill_id, dtype=np.int64),
        np.asarray(ids[pos + 1:], dtype=np.int64),
    ])
    out_labels = None
    if labels is not None:
        lab = list(labels)
        out_labels = np.concatenate([
            np.asarray(lab[:pos], dtype=np.int64),
            np.full((num_video_tokens,), IGNORE_INDEX, dtype=np.int64),
            np.asarray(lab[pos + 1:], dtype=np.int64),
        ])
    return out_ids, out_labels, pos


def det_gather_positions(spliced_ids: np.ndarray, det_token_id: int,
                         max_phrases: int):
    """Indices whose next token is [DET] (the hidden state that emits it).

    Mirrors the reference det-token mask convention: the mask built in
    `model/GROVE.py:200-205` selects, in the spliced sequence, the position
    *preceding* each [DET] token.
    """
    (where,) = np.nonzero(spliced_ids[1:] == det_token_id)
    where = where[:max_phrases]
    positions = np.zeros((max_phrases,), dtype=np.int64)
    mask = np.zeros((max_phrases,), dtype=bool)
    positions[:len(where)] = where
    mask[:len(where)] = True
    return positions, mask


def pack_text(
    input_ids: Sequence[int],
    conversation: Optional[str],
    tokenizer,
    *,
    num_video_tokens: int,
    max_spliced_len: int,
    det_token_id: int,
    max_phrases: int,
    pad_id: int = 0,
    video_fill_id: int = 0,
    with_labels: bool = True,
    template: str = "llava_v1",
) -> PackedText:
    """Full host-side packing of one conversation into static arrays."""
    labels = None
    if with_labels:
        labels = mask_conversation_targets(input_ids, conversation, tokenizer,
                                           template)
    ids, labels, video_pos = splice_video_tokens(
        input_ids, labels, num_video_tokens, video_fill_id)
    length = int(ids.shape[0])
    if length > max_spliced_len:
        ids = ids[:max_spliced_len]
        if labels is not None:
            labels = labels[:max_spliced_len]
        length = max_spliced_len

    det_positions, phrase_mask = det_gather_positions(
        ids, det_token_id, max_phrases)

    padded_ids = np.full((max_spliced_len,), pad_id, dtype=np.int32)
    padded_ids[:length] = ids
    attn = np.zeros((max_spliced_len,), dtype=bool)
    attn[:length] = True
    padded_labels = np.full((max_spliced_len,), IGNORE_INDEX, dtype=np.int32)
    if labels is not None:
        padded_labels[:length] = labels

    return PackedText(
        input_ids=padded_ids,
        video_start=np.asarray(video_pos, dtype=np.int32),
        attn_mask=attn,
        labels=padded_labels,
        det_positions=det_positions.astype(np.int32),
        phrase_mask=phrase_mask,
        length=length,
    )
