"""ActivityNet-Entities dataset adapter.

Copy of `grove_tpu/data/datasets/anet_entities.py`, held equal to it by
`tests/test_torch_data.py`; the boxes go through `base`'s numpy
conversions, and `.npy` clips (`data.synthetic`) are found beside the
video files.

Annotation schema (official anet_entities JSON, reference
`dataset/video_grounding_datasets/ActivityNetEntities.py`):
  {video_id: {"fps", "num_frames", "duration", "segments": {segment_id: {
      "tokens": [words], "process_clss": [[cls, ...]],
      "process_bnd_box": [[x1, y1, x2, y2]], "frame_ind": [0..9],
      "process_idx": [[word_idx]], "timestamps": [start_s, end_s]}}}}
plus a frame-timestamps dict {video_id: [stored frame ts...]} for decoding.

Semantics preserved: segment filtering rules (`:54-75`), first-occurrence
phrase spans with substring matching (`:80-105`), 10 segment-midpoint
timestamps with annotated frames pinned into the 8 training samples
(`:151-184,214-225`), one box per label in its annotated frame only
(`:293-300`), frames decoded at the closest stored timestamps and scaled to
width 720 (`:227-259`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..preprocess import preprocess_frames
from .base import box_xyxy_to_cxcywh, normalize_boxes

VIDEO_EXTENSIONS = (".mp4", ".mov", ".mkv", ".avi", ".webm", ".gif", ".npy")


def find_first_occurrences(caption: str, labels: List[str]):
    """Substring-tolerant first-occurrence spans (`:80-105`)."""
    tokens_positive = []
    used = set()
    words = caption.split()
    for label in labels:
        if label in used:
            continue
        for word in words:
            if label in word:
                start = caption.find(word)
                tokens_positive.append((start, start + len(word)))
                used.add(label)
                break
    return tokens_positive


def compute_midpoint_timestamps(start: float, end: float,
                                total_segments: int = 10) -> List[float]:
    b = np.linspace(start, end, total_segments + 1)
    return [(b[i] + b[i + 1]) / 2 for i in range(total_segments)]


class ActivityNetEntitiesDataset:
    def __init__(self, ann_path: str, video_dir: str,
                 frame_timestamps: Dict[str, List[float]],
                 decoder_factory, num_frames: int = 8,
                 clip_size: int = 336, sam_size: int = 512,
                 max_phrases: int = 16, validation: bool = False,
                 keys: Optional[List[str]] = None, seed: int = 0,
                 target_width: int = 720):
        with open(ann_path) as f:
            self.annotations = json.load(f)
        self.video_dir = video_dir
        self.frame_timestamps = frame_timestamps
        self.decoder_factory = decoder_factory
        self.num_frames = num_frames
        self.clip_size = clip_size
        self.sam_size = sam_size
        self.max_phrases = max_phrases
        self.validation = validation
        self.target_width = target_width
        self.rng = np.random.default_rng(seed)

        keys = keys if keys is not None else sorted(self.annotations.keys())
        self.segment_map: List[Tuple[str, str]] = []
        for video_id in keys:
            segments = self.annotations[video_id].get("segments", {})
            for segment_id in segments:
                seg = segments[segment_id]
                labels = [g[0].lower() for g in seg["process_clss"]]
                caption = " ".join(seg["tokens"]).lower()
                label_not_in_caption = not any(l in caption for l in labels)
                start_time, end_time = seg["timestamps"]
                if video_id in self.frame_timestamps:
                    end_time = min(end_time,
                                   self.frame_timestamps[video_id][-2])
                if (len(labels) != len(set(labels)) or not labels
                        or label_not_in_caption or start_time >= end_time
                        or (end_time - start_time) < 0.5):
                    continue
                self.segment_map.append((video_id, segment_id))

    def __len__(self):
        return len(self.segment_map)

    def _video_path(self, video_id: str) -> str:
        for ext in VIDEO_EXTENSIONS:
            p = os.path.join(self.video_dir, f"{video_id}{ext}")
            if os.path.exists(p):
                return p
        return os.path.join(self.video_dir, f"{video_id}.mp4")

    def parse_segment(self, video_id: str, segment_id: str) -> Dict:
        seg = self.annotations[video_id]["segments"][segment_id]
        caption = " ".join(seg["tokens"]).lower()
        labels = [g[0].lower() for g in seg["process_clss"]]
        bboxes = [np.asarray(b, np.float32) for b in seg["process_bnd_box"]]
        frame_indices = list(seg["frame_ind"])
        tokens_positive = find_first_occurrences(caption, labels)
        order = sorted(range(len(tokens_positive)),
                       key=lambda i: tokens_positive[i][0])
        return {
            "caption": caption,
            "labels": [labels[i] for i in order],
            "bboxes": [bboxes[i] for i in order],
            "tokens_positive": [tokens_positive[i] for i in order],
            "frame_indices": [frame_indices[i] for i in order],
            "timestamps": seg["timestamps"],
        }

    def sample_timestamps(self, start, end, num_segments, annotated):
        """8 samples with annotated timestamps pinned (`:151-184`)."""
        bounds = np.linspace(start, end, num_segments + 1)
        out = []
        for i in range(num_segments):
            s, e = bounds[i], bounds[i + 1]
            in_seg = [t for t in annotated if s <= t < e]
            if in_seg:
                if not self.validation:
                    out.append(float(self.rng.choice(in_seg)))
                else:
                    out.append(in_seg[0])
            elif not self.validation:
                out.append(float(self.rng.uniform(s, e)))
            else:
                out.append((s + e) / 2)
        return out

    def decode_frames(self, video_id: str, timestamps: List[float]):
        stored = self.frame_timestamps[video_id]
        adjusted = [stored[int(np.argmin([abs(ft - t) for ft in stored]))]
                    for t in timestamps]
        with self.decoder_factory(self._video_path(video_id)) as dec:
            native_w, native_h = dec.width, dec.height
            w = self.target_width
            h = int(round(native_h * w / max(native_w, 1)))
            order = np.argsort(adjusted)
            frames_sorted = dec.decode_at([adjusted[i] for i in order],
                                          out_size=(w, h))
        frames = np.empty_like(frames_sorted)
        for rank, src in enumerate(order):
            frames[src] = frames_sorted[rank]
        return frames, w, h

    def __getitem__(self, index: int) -> Dict:
        video_id, segment_id = self.segment_map[index]
        ann = self.parse_segment(video_id, segment_id)
        start_time, end_time = ann["timestamps"]
        end_time = min(end_time, self.frame_timestamps[video_id][-2])

        midpoints = compute_midpoint_timestamps(start_time, end_time, 10)
        annotated = [midpoints[i] for i in ann["frame_indices"]]
        sampled = self.sample_timestamps(start_time, end_time,
                                         self.num_frames, annotated)
        frames, w, h = self.decode_frames(video_id, sampled)

        p = self.max_phrases
        t = self.num_frames
        gt_boxes = np.zeros((t, p, 4), np.float32)
        gt_obj = np.zeros((t, p), np.float32)
        for li, atime in enumerate(zip(ann["labels"], annotated)):
            label, at = atime
            if li >= p or at not in sampled:
                continue
            ti = sampled.index(at)
            gt_obj[ti, li] = 1.0
            xyxy = ann["bboxes"][li]
            gt_boxes[ti, li] = normalize_boxes(box_xyxy_to_cxcywh(xyxy), w, h)

        frames_clip, frames_sam = preprocess_frames(
            frames, self.clip_size, self.sam_size)
        return {
            "frames_clip": frames_clip,
            "frames_sam": frames_sam,
            "gt_boxes": gt_boxes,
            "gt_objectness": gt_obj,
            "caption": ann["caption"],
            "tokens_positive": ann["tokens_positive"],
            "phrases": ann["labels"][:p],
            "original_size": (w, h),
            "video_path": self._video_path(video_id),
            "video_id": video_id,
            "segment_id": segment_id,
        }
