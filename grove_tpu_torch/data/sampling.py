"""Sliding-window frame coverage for inference.

Copy of `grove_tpu/data/sampling.py:38-79` (reference
`infer_iground.py:110-148,168-172`). It is copied, not imported, because
importing `grove_tpu.data` pulls in PIL; a test holds the two equal.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def sliding_segment_with_mask(num_frames: int, num_segments: int = 8
                              ) -> Tuple[List[List[int]], List[List[int]]]:
    """All `num_segments`-frame windows covering the clip + first-seen
    masks: window `offset` picks frames [i*seg + offset for i in range(n)]."""
    segment_size = num_frames // num_segments
    remainder = num_frames % num_segments
    all_indices: List[List[int]] = []
    masks: List[List[int]] = []
    seen = set()

    for offset in range(segment_size):
        frame_indices = [i * segment_size + offset
                         for i in range(num_segments)]
        mask = [1 if idx not in seen else 0 for idx in frame_indices]
        all_indices.append(frame_indices)
        masks.append(mask)
        seen.update(frame_indices)

    if remainder > 0:
        for offset in range(remainder):
            frame_indices = [i * segment_size + segment_size + offset
                             for i in range(num_segments)]
            frame_indices = [i for i in frame_indices if i < num_frames]
            if frame_indices:
                mask = [1 if idx not in seen else 0 for idx in frame_indices]
                all_indices.append(frame_indices)
                masks.append(mask)
                seen.update(frame_indices)

    return all_indices, masks


def center_window_index(masks: Sequence[Sequence[int]]) -> int:
    """The caption-generating window: middle of the all-fresh windows."""
    last_all_ones = 0
    for i, m in enumerate(masks):
        if all(m):
            last_all_ones = i
    return last_all_ones // 2
