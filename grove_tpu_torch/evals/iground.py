"""iGround / HowToGround evaluation: mIoU, grounding recall, box AP.

Copy of `grove_tpu/evals/iground.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

Re-implementations of `eval_iground.py` in pure numpy (this environment has
no pycocotools / BERT):
  * `compute_iou` keeps the reference's +1 pixel convention
    (`eval_iground.py:39-56`);
  * mean IoU over all pred x gt pairs per frame, "flattening" or per-video
    (`eval_iground.py:100-152`);
  * grounding recall with greedy IoU-ordered one-to-one matching gated on
    IoU >= t AND text-sim >= t (`eval_iground.py:70-98,154-238`) — the text
    similarity function is pluggable (BERT cosine in the reference; default
    here is a TF cosine over word tokens);
  * COCO-style box AP @[.5:.95] with 101-point interpolation (the
    pycocotools metric the reference computes, `eval_iground.py:240-266`).

Prediction/GT schema: {video_id: [per-frame dict(bboxes (K,4) xyxy,
labels [str], scores (K,))]}.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def compute_iou(a, b) -> float:
    """Single-pair IoU with the reference's +1 convention."""
    xA = max(a[0], b[0]); yA = max(a[1], b[1])
    xB = min(a[2], b[2]); yB = min(a[3], b[3])
    inter = max(0, xB - xA + 1) * max(0, yB - yA + 1)
    areaA = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
    areaB = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
    denom = float(areaA + areaB - inter)
    return inter / denom if denom != 0 else 0.0


def coco_iou(a, b) -> float:
    """pycocotools bbox IoU: xyxy with area (x2-x1)*(y2-y1), NO +1.

    The reference converts boxes to COCO xywh with w = x2-x1 before
    handing them to COCOeval, so the AP metric's IoU differs from
    `eval_iground.py:39-56`'s +1-convention `compute_iou` (which the
    reference only uses for mIoU/recall). Matching pycocotools exactly
    here keeps AP numbers comparable."""
    xA = max(a[0], b[0]); yA = max(a[1], b[1])
    xB = min(a[2], b[2]); yB = min(a[3], b[3])
    inter = max(0.0, xB - xA) * max(0.0, yB - yA)
    areaA = (a[2] - a[0]) * (a[3] - a[1])
    areaB = (b[2] - b[0]) * (b[3] - b[1])
    denom = float(areaA + areaB - inter)
    return inter / denom if denom > 0 else 0.0


def compute_iou_matrix(preds, gts) -> np.ndarray:
    m = np.zeros((len(preds), len(gts)))
    for i, p in enumerate(preds):
        for j, g in enumerate(gts):
            m[i, j] = compute_iou(p, g)
    return m


def token_tf_cosine(a: str, b: str) -> float:
    """Default text similarity: TF cosine over lowercase word tokens."""
    ca, cb = Counter(a.lower().split()), Counter(b.lower().split())
    common = set(ca) & set(cb)
    num = sum(ca[w] * cb[w] for w in common)
    den = (np.sqrt(sum(v * v for v in ca.values()))
           * np.sqrt(sum(v * v for v in cb.values())))
    return float(num / den) if den > 0 else 0.0


def find_best_matches(gt_boxes, gt_labels, dt_boxes, dt_labels,
                      iou_threshold: float, text_sim_threshold: float,
                      text_sim: Callable[[str, str], float] = token_tf_cosine):
    """Greedy IoU-ordered one-to-one matching (`eval_iground.py:70-98`)."""
    ious = compute_iou_matrix(gt_boxes, dt_boxes)
    sims = np.zeros((len(gt_labels), len(dt_labels)))
    for i, gl in enumerate(gt_labels):
        for j, dl in enumerate(dt_labels):
            sims[i, j] = text_sim(gl, dl)
    matches = []
    while ious.size > 0:
        idx = np.unravel_index(np.argmax(ious), ious.shape)
        if ious[idx] < iou_threshold or sims[idx] < text_sim_threshold:
            break
        matches.append(idx)
        ious[idx[0], :] = 0
        ious[:, idx[1]] = 0
        sims[idx[0], :] = 0
        sims[:, idx[1]] = 0
    return matches


def mean_iou(preds: Dict, gts: Dict, mode: str = "flattening") -> float:
    """Mean of all-pairs IoU means per frame (`eval_iground.py:100-152`)."""
    def frame_miou(video_id):
        out = []
        for pf, gf in zip(preds[video_id], gts[video_id]):
            pb, gb = pf["bboxes"], gf["bboxes"]
            if len(pb) and len(gb):
                out.append(compute_iou_matrix(pb, gb).mean())
        return out

    if mode == "flattening":
        mious = [m for vid in gts for m in frame_miou(vid)]
        return float(np.mean(mious)) if mious else 0.0
    video_mious = []
    for vid in gts:
        fm = frame_miou(vid)
        video_mious.append(float(np.mean(fm)) if fm else 0.0)
    return float(np.mean(video_mious)) if video_mious else 0.0


def grounding_recall(preds: Dict, gts: Dict, iou_threshold: float = 0.5,
                     text_sim_threshold: float = 0.5,
                     text_sim: Callable = token_tf_cosine,
                     mode: str = "flattening") -> float:
    """Recall of GT phrases matched 1-1 (`eval_iground.py:154-238`)."""
    def frame_counts(vid):
        tp = ap = 0
        for pf, gf in zip(preds[vid], gts[vid]):
            gt_labels = list(gf["labels"])
            dt_labels = list(pf["labels"])
            ap += len(gt_labels)
            m = find_best_matches(gf["bboxes"], gt_labels, pf["bboxes"],
                                  dt_labels, iou_threshold,
                                  text_sim_threshold, text_sim)
            tp += len(m)
        return tp, ap

    if mode == "flattening":
        tp = ap = 0
        for vid in gts:
            t, a = frame_counts(vid)
            tp += t
            ap += a
        return tp / ap if ap > 0 else 0.0
    recalls = []
    for vid in gts:
        t, a = frame_counts(vid)
        recalls.append(t / a if a > 0 else 0.0)
    return float(np.mean(recalls)) if recalls else 0.0


def box_average_precision(preds: Dict, gts: Dict,
                          iou_thresholds: Optional[Sequence[float]] = None,
                          mode: str = "flattening") -> Dict[str, float]:
    """COCO-style single-category AP.

    mode "flattening": all frames pooled (the reference's default);
    mode "video": AP computed per video then averaged
    (`eval_iground.py:240-266` evaluate_ap_per_video).

    Detections are ranked globally by score; per IoU threshold, greedy match
    against unmatched GT (highest IoU first); AP = 101-point interpolated
    area under P(R). Returns AP (mean over thresholds), AP50, AP75.
    pycocotools semantics throughout: no-+1 IoU (`coco_iou`), maxDets=100
    detections per frame, recThrs = linspace(0, 1, 101).
    """
    if mode == "video":
        per_video = [
            box_average_precision({v: preds[v]}, {v: gts[v]},
                                  iou_thresholds, mode="flattening")
            for v in gts]
        if not per_video:
            return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}
        return {k: float(np.mean([m[k] for m in per_video]))
                for k in per_video[0]}

    if iou_thresholds is None:
        # linspace, not arange: pycocotools' exact grid — the two differ in
        # float representation at e.g. 0.8, which flips boundary matches
        iou_thresholds = np.linspace(0.5, 0.95, 10)

    # flatten detections and GT per frame
    frames = []
    for vid in gts:
        for fi, (pf, gf) in enumerate(zip(preds[vid], gts[vid])):
            frames.append((pf, gf))
    total_gt = sum(len(gf["bboxes"]) for _, gf in frames)
    if total_gt == 0:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}

    aps = {}
    for th in iou_thresholds:
        records = []  # (score, is_tp)
        for pf, gf in frames:
            pb = np.asarray(pf["bboxes"], np.float64).reshape(-1, 4)
            scores = np.asarray(pf.get("scores",
                                       np.ones(len(pb))), np.float64)
            gb = np.asarray(gf["bboxes"], np.float64).reshape(-1, 4)
            order = np.argsort(-scores, kind="stable")[:100]  # maxDets=100
            matched = np.zeros(len(gb), bool)
            for i in order:
                if len(gb) == 0:
                    records.append((scores[i], False))
                    continue
                ious = np.array([coco_iou(pb[i], g) for g in gb])
                ious[matched] = -1
                j = int(np.argmax(ious))
                if ious[j] >= th:
                    matched[j] = True
                    records.append((scores[i], True))
                else:
                    records.append((scores[i], False))
        if not records:
            aps[th] = 0.0
            continue
        records.sort(key=lambda r: -r[0])
        tps = np.cumsum([r[1] for r in records])
        fps = np.cumsum([not r[1] for r in records])
        rec = tps / total_gt
        prec = tps / np.maximum(tps + fps, 1e-9)
        # 101-point interpolation
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = prec[rec >= r].max() if (rec >= r).any() else 0.0
            ap += p / 101
        aps[th] = ap

    vals = np.array([aps[t] for t in iou_thresholds])
    return {"AP": float(vals.mean()),
            "AP50": float(aps[iou_thresholds[0]]),
            "AP75": float(aps[iou_thresholds[5]]
                          if len(iou_thresholds) > 5 else 0.0)}
