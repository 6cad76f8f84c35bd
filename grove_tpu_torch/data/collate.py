"""Batch assembly: sample dicts -> static model batch.

A copy of `grove_tpu/data/collate.py` (numpy only; the port imports nothing
of the JAX package), held equal to it by `tests/test_torch_misc.py`.
Re-design of `dataset/dataset.py:custom_collate_fn:9-99`: conversation build
(tagged caption + random question template), `<video>` ->
`<vid_start><video><vid_end>` wrap, sentinel tokenization, CE target masking,
then the ragged->static packing of `text.packing`. Everything comes out as
fixed-shape numpy arrays for the train step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import GroveConfig
from ..text import tagging
from ..text.conversation import build_prompt
from ..text.packing import pack_text
from ..text.prompts import (VIDEO_GROUNDING_QUESTIONS, tokenize_with_video,
                            video_instruction)


def conversation_for_sample(sample: Dict, rng: Optional[np.random.Generator],
                            question_templates=VIDEO_GROUNDING_QUESTIONS,
                            ) -> str:
    """Random question + tagged caption answer (`HowTo100M.py:180-199`)."""
    if rng is not None:
        q = question_templates[int(rng.integers(len(question_templates)))]
    else:
        q = question_templates[0]
    answer = tagging.tag_caption(sample["caption"],
                                 sample["tokens_positive"])
    return build_prompt(video_instruction(q.strip()), answer)


def build_batch(samples: Sequence[Dict], tokenizer, cfg: GroveConfig,
                rng: Optional[np.random.Generator] = None,
                with_labels: bool = True,
                conversations: Optional[List[str]] = None,
                question_templates=VIDEO_GROUNDING_QUESTIONS,
                ) -> Dict[str, np.ndarray]:
    """Stack samples into the static batch consumed by GroveModel."""
    max_len = cfg.max_seq_len + cfg.splice_offset
    packed, convs = [], []
    for i, s in enumerate(samples):
        conv = (conversations[i] if conversations is not None
                else conversation_for_sample(s, rng, question_templates))
        ids = tokenize_with_video(conv, tokenizer)
        p = pack_text(ids, conv, tokenizer,
                      num_video_tokens=cfg.num_video_tokens,
                      max_spliced_len=max_len,
                      det_token_id=cfg.tokens.det,
                      max_phrases=cfg.max_phrases,
                      pad_id=tokenizer.pad_token_id,
                      with_labels=with_labels)
        packed.append(p)
        convs.append(conv)

    batch = {
        "frames_clip": np.stack([s["frames_clip"] for s in samples]),
        "frames_sam": np.stack([s["frames_sam"] for s in samples]),
        **({"sam_valid_hw": np.stack([s["sam_valid_hw"] for s in samples])}
           if "sam_valid_hw" in samples[0] else {}),
        "input_ids": np.stack([p.input_ids for p in packed]),
        "video_start": np.stack([p.video_start for p in packed]),
        "labels": np.stack([p.labels for p in packed]),
        "det_positions": np.stack([p.det_positions for p in packed]),
        "phrase_mask": np.stack([p.phrase_mask for p in packed]
                                ).astype(np.float32),
        "gt_boxes": np.stack([s["gt_boxes"] for s in samples]),
        "gt_objectness": np.stack([s["gt_objectness"] for s in samples]),
    }
    # consistency: a phrase whose [DET] survived truncation must exist in GT;
    # extra GT phrases beyond the det-token count are masked out of the loss
    batch["gt_objectness"] = (batch["gt_objectness"]
                              * batch["phrase_mask"][:, None, :])
    meta = {
        "conversations": convs,
        "video_paths": [s.get("video_path") for s in samples],
        "original_sizes": [s.get("original_size") for s in samples],
    }
    return batch, meta
