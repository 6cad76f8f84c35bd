"""iGround evaluation driver: GT annotations + predictions pickle -> metrics.

Copy of `grove_tpu/evals/run_iground.py` (numpy and the standard library;
no JAX): everything after this docstring is the original's text, held equal
to it by `tests/test_torch_evals.py`; its relative import of
`data.datasets.howto100m` reaches the port's copy.

Rebuild of `eval_iground.py`'s CLI flow without the COCO-JSON detour: GT is
read straight from the annotation pickles (same schema as training), the
predictions pickle is the output of `grove_tpu_torch.infer.drivers`.
Prints bbox AP, mean IoU (flattening + per-video), grounding recall, and
caption metrics.

Run: python -m grove_tpu_torch.evals.run_iground --ann_dir ... \
         --video_dir ... --pred predictions.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict

import numpy as np

from ..data.datasets.howto100m import parse_howto_annotation
from . import captions as caption_eval
from . import iground as box_eval


def load_gt(ann_dir: str, video_dir: str = "") -> Dict:
    """GT per video: per-frame {bboxes (xyxy), labels}; plus captions."""
    gts = {}
    caps = {}
    for f in sorted(os.listdir(ann_dir)):
        if not f.endswith(".pkl"):
            continue
        vid = os.path.splitext(f)[0]
        with open(os.path.join(ann_dir, f), "rb") as fh:
            ann_info = pickle.load(fh)
        ann = parse_howto_annotation(ann_info, video_dir)
        frames = []
        for fb, fo in zip(ann.frame_boxes, ann.frame_objectness):
            labels = [ann.phrases[i] for i in range(len(fo)) if fo[i] > 0]
            frames.append({"bboxes": np.asarray(fb, np.float64).reshape(-1, 4),
                           "labels": labels})
        gts[f"{vid}_0"] = frames
        caps[f"{vid}_0"] = [ann.caption]
    return gts, caps


def predictions_to_eval_format(preds_pkl: Dict) -> Dict:
    out = {}
    for uid, data in preds_pkl.items():
        frames = []
        for fi in range(len(data["pred_bboxes"])):
            boxes = np.asarray(data["pred_bboxes"][fi],
                               np.float64).reshape(-1, 4)
            labels = list(data["pred_labels"][fi])
            probs = np.asarray(data["probs_temp_objectness"][fi], np.float64)
            # scores for AP: the objectness prob of each KEPT box
            kept_scores = probs[probs > 0.0][:len(boxes)] if probs.size \
                else np.ones(len(boxes))
            if len(kept_scores) != len(boxes):
                kept_scores = np.ones(len(boxes))
            frames.append({"bboxes": boxes, "labels": labels,
                           "scores": kept_scores})
        out[uid] = frames
    return out


def evaluate(gts, caps_gt, preds_pkl, text_sim=None) -> Dict:
    preds = predictions_to_eval_format(preds_pkl)
    # align frame counts (predictions may be truncated by max_frames)
    for uid in list(gts.keys()):
        if uid not in preds:
            preds[uid] = [{"bboxes": np.zeros((0, 4)), "labels": [],
                           "scores": np.zeros((0,))}
                          for _ in gts[uid]]
        n = min(len(gts[uid]), len(preds[uid]))
        gts[uid] = gts[uid][:n]
        preds[uid] = preds[uid][:n]

    sim = text_sim or box_eval.token_tf_cosine
    metrics = {}
    metrics.update(box_eval.box_average_precision(preds, gts))
    # reference quirk: per-video mode reads coco_eval.stats[1], which is
    # AP@IoU=0.50 (the comment in `eval_iground.py:261` mislabels it as
    # .50:.95) — preserved so numbers stay comparable
    metrics["AP_video"] = box_eval.box_average_precision(
        preds, gts, mode="video")["AP50"]
    metrics["mIoU_flatten"] = box_eval.mean_iou(preds, gts, "flattening")
    metrics["mIoU_video"] = box_eval.mean_iou(preds, gts, "video")
    metrics["recall_flatten"] = box_eval.grounding_recall(
        preds, gts, text_sim=sim, mode="flattening")
    metrics["recall_video"] = box_eval.grounding_recall(
        preds, gts, text_sim=sim, mode="video")

    caps_res = {uid: preds_pkl[uid]["pred_text"] for uid in preds_pkl
                if uid in caps_gt}
    caps_sub = {uid: caps_gt[uid] for uid in caps_res}
    if caps_res:
        metrics.update(caption_eval.caption_metrics(caps_sub, caps_res))
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann_dir", required=True)
    p.add_argument("--video_dir", default="")
    p.add_argument("--pred", required=True)
    p.add_argument("--text_sim", default="tf",
                   help="grounding-recall similarity backend: tf | "
                        "char_ngram | embed:<path.npz> (the reference uses "
                        "BERT cosine; see evals/DEVIATIONS.md)")
    args = p.parse_args(argv)
    gts, caps = load_gt(args.ann_dir, args.video_dir)
    with open(args.pred, "rb") as f:
        preds_pkl = pickle.load(f)
    from .textsim import resolve_backend
    metrics = evaluate(gts, caps, preds_pkl,
                       text_sim=resolve_backend(args.text_sim))
    metrics["text_sim_backend"] = args.text_sim
    for k, v in metrics.items():
        if v is None:
            print(f"{k}: n/a (external assets unavailable)")
        elif isinstance(v, str):
            print(f"{k}: {v}")
        else:
            print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
