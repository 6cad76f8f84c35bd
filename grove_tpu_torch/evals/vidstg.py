"""VidSTG spatial grounding evaluation: gt_vIoU (+ thresholded recall).

Copy of `grove_tpu/evals/vidstg.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

Re-implementation of `eval_vidstg.py:66-245` without file-format coupling:
GT and predictions are plain dicts
  gt:   {video_id: {"frame_ids": [...], "boxes": [[x1,y1,x2,y2] or []],
                    }}
  pred: {video_id: {"frame_ids": [...], "boxes": [(1,4) array or empty],
                    "qtype": "declarative"|"interrogative"}}
Per video: gt_viou = mean over GT frames of IoU(pred, gt) (exact-union IoU,
no +1); per-category averages of gt_viou and gt_viou@{thresholds}.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def np_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) exact IoU (torchvision box_iou semantics, no +1)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def evaluate_vidstg(predictions: Dict, gt: Dict,
                    iou_thresholds: Sequence[float] = (0.3, 0.5)) -> Dict:
    vid_metrics = {}
    for video_id, gt_data in gt.items():
        if video_id not in predictions:
            raise RuntimeError(f"Missing prediction for video {video_id}")
        pred = predictions[video_id]
        pred_boxes, pred_fids = pred["boxes"], list(pred["frame_ids"])
        gt_viou = 0.0
        n = 0
        for fid, gbox in zip(gt_data["frame_ids"], gt_data["boxes"]):
            n += 1
            if not gbox:
                continue
            if fid not in pred_fids:
                raise RuntimeError(
                    f"Missing prediction for frame {fid} in {video_id}")
            pbox = np.asarray(pred_boxes[pred_fids.index(fid)])
            if pbox.size and pbox.any():
                gt_viou += float(np_box_iou(pbox, np.array([gbox]))[0, 0])
        gt_viou /= max(n, 1)
        m = {"qtype": pred.get("qtype", "declarative"), "gt_viou": gt_viou}
        for th in iou_thresholds:
            m[f"gt_viou@{th}"] = 1.0 if gt_viou > th else 0.0
        vid_metrics[video_id] = m

    out = {}
    qtypes = sorted(set(v["qtype"] for v in vid_metrics.values()))
    for q in qtypes:
        vids = [v for v in vid_metrics.values() if v["qtype"] == q]
        out[f"{q}_gt_viou"] = float(np.mean([v["gt_viou"] for v in vids]))
        for th in iou_thresholds:
            out[f"{q}_gt_viou@{th}"] = float(
                np.mean([v[f"gt_viou@{th}"] for v in vids]))
    return out
