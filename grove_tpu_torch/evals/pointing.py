"""Pointing-game accuracy (YouCook-Interactions / GroundingYouTube).

Copy of `grove_tpu/evals/pointing.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

Re-implementation of `eval_youcookinteractions.py:8-51`: a prediction is
correct when the predicted box center lies inside the GT box.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def pointing_accuracy(pred_boxes_dict: Dict[str, Dict],
                      gt_data: Sequence[Dict],
                      segment_key: str = "segment_idx"
                      ) -> Tuple[float, int, int]:
    """pred_boxes_dict: {unique_id: {"final_boxes": [per-frame (K,4) or
    None]}}; gt_data: per-clip dicts with video_id, segment idx and
    segment_bboxes [(x1,y1,x2,y2) or None]."""
    total_correct = 0
    total_valid = 0
    for clip in gt_data:
        unique_id = f"{clip['video_id']}_{clip[segment_key]}"
        pred_boxes = pred_boxes_dict.get(unique_id, {}).get("final_boxes", [])
        for pred_box, gt_box in zip(pred_boxes, clip["segment_bboxes"]):
            if not gt_box:
                continue
            xtl, ytl, xbr, ybr = gt_box
            total_valid += 1
            if pred_box is None or np.any(np.isnan(np.asarray(
                    pred_box, dtype=np.float64))):
                continue
            box = np.asarray(pred_box, np.float64).reshape(-1, 4)[0]
            cx = (box[0] + box[2]) / 2
            cy = (box[1] + box[3]) / 2
            if xtl <= cx <= xbr and ytl <= cy <= ybr:
                total_correct += 1
    acc = (total_correct / total_valid) * 100 if total_valid else 0.0
    return acc, total_correct, total_valid
