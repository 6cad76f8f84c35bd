"""ActivityNet-Entities grounding evaluation (GT mode).

Copy of `grove_tpu/evals/anet.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

Re-implementation of the official evaluator port in `eval_anet.py:22-221`:
per groundable word index, gather its 5-D GT boxes (xyxy + frame index) and
the predicted per-frame boxes; overlaps use the +1 pixel convention and a
frame mask (only same-frame pairs count); a word is correctly localized when
max overlap > iou_thresh. Accuracy is averaged per class, then over classes.

The generation-mode P/R/F1 path of the reference needs Java CoreNLP
lemmatization; a plain suffix-stripping lemma fallback is provided so the
metric is computable offline (callers can inject a better lemmatizer).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np


def _iou_plus1(a: np.ndarray, b: np.ndarray) -> float:
    iw = min(a[2], b[2]) - max(a[0], b[0]) + 1
    ih = min(a[3], b[3]) - max(a[1], b[1]) + 1
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    area_a = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
    area_b = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
    return inter / float(area_a + area_b - inter)


def gt_localization_accuracy(pred: Dict, ref: Dict,
                             iou_thresh: float = 0.5,
                             num_frames: int = 10) -> Dict:
    """pred: {vid: {seg: {"idx_in_sent": [...], "clss": [...],
    "bbox_for_all_frames": [per object: (num_frames, 4) xyxy]}}};
    ref: {vid: {"segments": {seg: {"process_bnd_box", "frame_ind",
    "process_idx", "process_clss"}}}}."""
    results = defaultdict(list)
    for vid, anns in ref.items():
        for seg, ann in anns["segments"].items():
            if len(ann["frame_ind"]) == 0:
                continue
            boxes = np.asarray(ann["process_bnd_box"], np.float64)
            frames = np.asarray(ann["frame_ind"], np.float64)
            sent_idx = set()
            for pi in ann["process_idx"]:
                sent_idx.update(pi)
            for idx in sorted(sent_idx):
                sel = [i for i, pi in enumerate(ann["process_idx"])
                       if idx in pi]
                class_name = ann["process_clss"][sel[0]][
                    ann["process_idx"][sel[0]].index(idx)]
                correct = 0
                if (vid in pred and seg in pred[vid]
                        and idx in pred[vid][seg]["idx_in_sent"]):
                    pi = pred[vid][seg]["idx_in_sent"].index(idx)
                    pred_boxes = np.asarray(
                        pred[vid][seg]["bbox_for_all_frames"][pi],
                        np.float64).reshape(-1, 4)[:num_frames]
                    best = 0.0
                    for fi, pbox in enumerate(pred_boxes):
                        for gbox, gframe in zip(boxes[sel], frames[sel]):
                            if int(gframe) != fi:
                                continue
                            best = max(best, _iou_plus1(pbox, gbox))
                    correct = 1 if best > iou_thresh else 0
                results[class_name].append(correct)

    if not results:
        return {"localization_accuracy": 0.0, "num_classes": 0}
    per_class = {c: sum(h) / len(h) for c, h in results.items()}
    return {
        "localization_accuracy": float(np.mean(list(per_class.values()))),
        "num_classes": len(results),
        "per_class": per_class,
    }


def naive_lemma(word: str) -> str:
    """Rule-based English lemmatizer (irregular table + orthographic
    repairs; see evals/lemma.py) standing in for CoreNLP. Name kept for
    backward compatibility — callers can still inject their own."""
    from .lemma import english_lemma
    return english_lemma(word)


def gen_grounding_f1(pred: Dict, ref: Dict, iou_thresh: float = 0.5,
                     num_frames: int = 10,
                     lemma: Callable[[str], str] = naive_lemma) -> Dict:
    """Generation-mode precision/recall/F1 ("all" variant): predicted
    objects matched to GT objects by lemma class equality; a match is a hit
    when the 5-D overlap clears the threshold (`eval_anet.py:224-402`)."""
    prec_res = defaultdict(list)
    rec_res = defaultdict(list)
    for vid, anns in ref.items():
        for seg, ann in anns["segments"].items():
            if len(ann["frame_ind"]) == 0:
                continue
            gt_boxes = np.asarray(ann["process_bnd_box"], np.float64)
            gt_frames = np.asarray(ann["frame_ind"], np.float64)
            gt_classes = [lemma(g[0].lower()) for g in ann["process_clss"]]
            p = pred.get(vid, {}).get(seg)
            pred_classes = ([lemma(c.lower()) for c in p["clss"]]
                            if p else [])

            def hit(pred_idx, gt_sel):
                pred_boxes = np.asarray(
                    p["bbox_for_all_frames"][pred_idx],
                    np.float64).reshape(-1, 4)[:num_frames]
                best = 0.0
                for fi, pbox in enumerate(pred_boxes):
                    for gi in gt_sel:
                        if int(gt_frames[gi]) != fi:
                            continue
                        best = max(best, _iou_plus1(pbox, gt_boxes[gi]))
                return best > iou_thresh

            # precision: every predicted object of a GT class
            for pi, pc in enumerate(pred_classes):
                if pc in gt_classes:
                    sel = [i for i, gc in enumerate(gt_classes) if gc == pc]
                    prec_res[pc].append(1 if hit(pi, sel) else 0)
            # recall: every GT object
            for gi, gc in enumerate(gt_classes):
                if gc in pred_classes:
                    pi = pred_classes.index(gc)
                    rec_res[gc].append(1 if hit(pi, [gi]) else 0)
                else:
                    rec_res[gc].append(0)

    prec = (float(np.mean([sum(h) / len(h) for h in prec_res.values()]))
            if prec_res else 0.0)
    rec = (float(np.mean([sum(h) / len(h) for h in rec_res.values()]))
           if rec_res else 0.0)
    f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    return {"precision_all": prec, "recall_all": rec, "f1_all": f1}
