"""Dataset base: annotation parsing + frame pipeline -> static sample dicts.

Copy of `grove_tpu/data/datasets/base.py`, held equal to it by
`tests/test_torch_data.py`, with two changes the port's rule forces (it
imports nothing of the JAX package): the box conversions are numpy
(`box_xyxy_to_cxcywh`, `normalize_boxes`, the float32 arithmetic of JAX's
`ops.boxes`), and frames go through the port's PIL-free
`data.preprocess.preprocess_frames_uint8`.

Re-designs the reference's torch `Dataset` classes
(`dataset/video_grounding_datasets/*.py`) as plain-python samplers producing
numpy dicts ready for `grove_tpu.data.collate.build_batch`. The ragged
(phrases x frames) ground truth becomes a dense (T, P, 4) box tensor + a
(T, P) objectness matrix, with the reference's phrase ordering (sorted by
caption position, `HowTo100M.py:115-122`) preserved so checkpoint-parity
evaluation sees identical phrase indices.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..preprocess import preprocess_frames_uint8
from ..sampling import sparse_sample

_TAG_RE = re.compile(r"<.*?>")


def box_xyxy_to_cxcywh(boxes) -> np.ndarray:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) in float32."""
    x1, y1, x2, y2 = np.moveaxis(np.asarray(boxes, np.float32), -1, 0)
    return np.stack([(x1 + x2) / np.float32(2), (y1 + y2) / np.float32(2),
                     x2 - x1, y2 - y1], axis=-1)


def normalize_boxes(boxes, img_w, img_h) -> np.ndarray:
    """x-coordinates over img_w, y-coordinates over img_h, in float32."""
    scale = np.array([img_w, img_h, img_w, img_h], np.float32)
    return np.asarray(boxes, np.float32) / scale


@dataclasses.dataclass
class ClipAnnotation:
    """Parsed clip annotation in reference schema (`HowTo100M.py:77-154`)."""
    video_path: str
    caption: str
    phrases: List[str]                       # sorted by caption position
    tokens_positive: List[Tuple[int, int]]   # char spans into caption
    # frame-level ground truth at the annotation fps:
    frame_boxes: List[np.ndarray]            # per frame: (K_t, 4) xyxy pixels
    frame_objectness: List[np.ndarray]       # per frame: (P,) 0/1 by phrase
    width: int
    height: int
    fps: float
    clip_start_frame: int = 0
    clip_end_frame: int = 0


def phrase_spans_from_tagged(caption: str, tagged_caption: str,
                             phrases: Sequence[str]
                             ) -> List[Tuple[int, int]]:
    """Locate each phrase's span in the clean caption via the tagged one.

    Mirrors `HowTo100M.py:92-114`: find `<p>phrase</p>` in the tagged
    caption, then subtract the tag characters before it.
    """
    spans = []
    for phrase in phrases:
        pattern = r"<p>" + re.escape(phrase) + r"</p>"
        matches = list(re.finditer(pattern, tagged_caption))
        if matches:
            start_tagged = matches[0].start()
            before = _TAG_RE.sub("", tagged_caption[:start_tagged])
            start = len(before)
            spans.append((start, start + len(phrase)))
        else:
            # fallback: plain find (reference would reuse the previous span;
            # a direct search is strictly more robust)
            idx = caption.find(phrase)
            spans.append((max(idx, 0), max(idx, 0) + len(phrase)))
    return spans


def sort_phrases_by_span(phrases, spans):
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    return ([phrases[i] for i in order], [spans[i] for i in order], order)


def dense_ground_truth(ann: ClipAnnotation, frame_indices: np.ndarray,
                       max_phrases: int):
    """Ragged per-frame GT -> dense (T, P, 4) cxcywh-normalized + (T, P)."""
    t = len(frame_indices)
    p = max_phrases
    boxes = np.zeros((t, p, 4), np.float32)
    obj = np.zeros((t, p), np.float32)
    n_ph = min(len(ann.phrases), p)
    for ti, fi in enumerate(frame_indices):
        fobj = ann.frame_objectness[fi]
        fboxes = ann.frame_boxes[fi]
        obj[ti, :n_ph] = fobj[:n_ph]
        # reference stores boxes for visible phrases sorted by phrase index
        vis = [i for i in range(len(fobj)) if fobj[i] > 0]
        for bi, phrase_idx in enumerate(vis):
            if phrase_idx >= p or bi >= len(fboxes):
                continue
            xyxy = np.asarray(fboxes[bi], np.float32)
            cxcywh = normalize_boxes(box_xyxy_to_cxcywh(xyxy), ann.width,
                                     ann.height)
            boxes[ti, phrase_idx] = cxcywh
    # zero out objectness for phrases beyond the cap
    obj[:, n_ph:] = 0.0
    return boxes, obj


class GroundingVideoDataset:
    """Shared machinery: decode -> sample -> preprocess -> sample dict."""

    def __init__(self, decoder_factory, num_frames: int = 8,
                 clip_size: int = 336, sam_size: int = 512,
                 max_phrases: int = 16, validation: bool = False,
                 fps: float = 5.0, seed: int = 0):
        self.decoder_factory = decoder_factory
        self.num_frames = num_frames
        self.clip_size = clip_size
        self.sam_size = sam_size
        self.max_phrases = max_phrases
        self.validation = validation
        self.fps = fps
        self.rng = np.random.default_rng(seed)

    # subclasses implement: __len__, load_annotation(index) -> ClipAnnotation

    def frame_timestamps(self, ann: ClipAnnotation) -> np.ndarray:
        """Annotation-frame timestamps at the dataset fps
        (`HowTo100M.py:281-306`: frame ids start..end step fps ratio)."""
        rate = max(int(ann.fps / self.fps), 1)
        ids = list(range(ann.clip_start_frame, ann.clip_end_frame + 1, rate))
        if len(ids) > len(ann.frame_boxes):
            ids = list(range(ann.clip_start_frame, ann.clip_end_frame, rate))
        return np.asarray([i / ann.fps for i in ids], np.float64)

    def build_sample(self, ann: ClipAnnotation) -> Dict[str, np.ndarray]:
        ts = self.frame_timestamps(ann)
        n_total = len(ts)

        # sparse sampling with the visibility retry of `HowTo100M.py:329-336`
        for _ in range(64):
            mode = "center" if self.validation else "random"
            idx = sparse_sample(n_total, self.num_frames, mode=mode,
                                rng=self.rng)
            vis = any(ann.frame_objectness[i].sum() > 0 for i in idx
                      if i < len(ann.frame_objectness))
            if vis or self.validation:
                break

        with self.decoder_factory(ann.video_path) as dec:
            frames = dec.decode_at(ts[idx])
        # frames stay uint8 on the host; the model normalizes on device
        # (4x less host->device traffic than float32)
        clip_frames, sam_frames, sam_valid = preprocess_frames_uint8(
            frames, self.clip_size, self.sam_size)
        gt_boxes, gt_obj = dense_ground_truth(ann, idx, self.max_phrases)
        return {
            "frames_clip": clip_frames,
            "frames_sam": sam_frames,
            "sam_valid_hw": sam_valid,
            "gt_boxes": gt_boxes,
            "gt_objectness": gt_obj,
            "caption": ann.caption,
            "tokens_positive": ann.tokens_positive,
            "phrases": ann.phrases[:self.max_phrases],
            "original_size": (ann.width, ann.height),
            "video_path": ann.video_path,
            "frame_indices": idx,
        }
