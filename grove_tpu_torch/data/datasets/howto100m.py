"""HowTo100M / HowToGround / iGround dataset adapter.

Copy of `grove_tpu/data/datasets/howto100m.py`, held equal to it by
`tests/test_torch_data.py`.

Annotation schema: one pickle per video id under `ann_dir`
(`{video_id}.pkl`, reference `HowTo100M.py:57-60`) holding a dict with
  video_fname, fps, clip_start_frame, clip_end_frame, width, height,
  caption, tagged_caption, phrases,
  bboxes  - per annotation frame: list of xyxy boxes (visible phrases,
            phrase-index order)
  labels  - per annotation frame: list of phrase strings matching bboxes.

Parsing reproduces `_parse_annotations` (`HowTo100M.py:77-154`): phrases are
located via the tagged caption, sorted by caption position; each frame gets a
(P,) objectness vector and boxes re-sorted into phrase-index order.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .base import (ClipAnnotation, GroundingVideoDataset,
                   phrase_spans_from_tagged, sort_phrases_by_span)


def parse_howto_annotation(ann_info: Dict, video_dir: str) -> ClipAnnotation:
    caption = ann_info["caption"].strip('"').strip().lower()
    tagged = ann_info["tagged_caption"].strip('"').strip().lower()
    phrases = [p.lower() for p in ann_info["phrases"]]

    spans = phrase_spans_from_tagged(caption, tagged, phrases)
    phrases, spans, _ = sort_phrases_by_span(phrases, spans)
    n = len(phrases)

    frame_boxes: List[np.ndarray] = []
    frame_obj: List[np.ndarray] = []
    for fboxes, flabels in zip(ann_info["bboxes"], ann_info["labels"]):
        obj = np.zeros(n, np.float32)
        boxes, label_idx = [], []
        for bbox, lab in zip(fboxes, flabels):
            li = phrases.index(lab.lower())
            obj[li] = 1
            boxes.append(np.asarray(bbox, np.float32))
            label_idx.append(li)
        order = sorted(range(len(boxes)), key=lambda i: label_idx[i])
        frame_boxes.append(np.asarray([boxes[i] for i in order], np.float32)
                           if boxes else np.zeros((0, 4), np.float32))
        frame_obj.append(obj)

    return ClipAnnotation(
        video_path=os.path.join(video_dir, ann_info["video_fname"]),
        caption=caption,
        phrases=phrases,
        tokens_positive=spans,
        frame_boxes=frame_boxes,
        frame_objectness=frame_obj,
        width=int(ann_info["width"]),
        height=int(ann_info["height"]),
        fps=float(ann_info["fps"]),
        clip_start_frame=int(ann_info["clip_start_frame"]),
        clip_end_frame=int(ann_info["clip_end_frame"]),
    )


class HowTo100MDataset(GroundingVideoDataset):
    def __init__(self, ann_dir: str, video_dir: str,
                 keys: Optional[Sequence[str]] = None,
                 manifest: Optional[str] = None,
                 shard_rank: int = 0, shard_world: int = 1, **kw):
        """`manifest` enables streaming-scale startup: keys come from a
        prebuilt manifest file (tools/build_index.py) and only this host's
        `shard_rank::shard_world` stride is loaded (see data/index.py) —
        no directory walk, 1/world index memory. Without it, keys are
        listed from `ann_dir` (reference `HowTo100M.py:57-60` behavior)."""
        super().__init__(**kw)
        self.ann_dir = ann_dir
        self.video_dir = video_dir
        if keys is None:
            if manifest is not None:
                from ..index import read_manifest
                keys = read_manifest(manifest, shard_rank, shard_world)
            else:
                keys = sorted(
                    os.path.splitext(f)[0]
                    for f in os.listdir(ann_dir) if f.endswith(".pkl"))
        self.keys = list(keys)

    def __len__(self):
        return len(self.keys)

    def load_annotation(self, index: int) -> ClipAnnotation:
        with open(os.path.join(self.ann_dir, f"{self.keys[index]}.pkl"),
                  "rb") as f:
            ann_info = pickle.load(f)
        return parse_howto_annotation(ann_info, self.video_dir)

    def __getitem__(self, index: int):
        return self.build_sample(self.load_annotation(index))
