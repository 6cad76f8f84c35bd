"""Thin eval CLIs for VidSTG / ANet-Entities / pointing-game tasks.

Copy of `grove_tpu/evals/run_all.py` (numpy and the standard library; no
JAX): everything after this docstring is the original's text, held
equal to it by `tests/test_torch_evals.py`.

Each consumes the predictions pickle of `grove_tpu_torch.infer.drivers`
plus the task's annotation file, mirroring the reference's eval_* scripts:

  python -m grove_tpu_torch.evals.run_all vidstg --ann vidstg.json --pred p.pkl
  python -m grove_tpu_torch.evals.run_all anet --ann anet.json --pred p.pkl
  python -m grove_tpu_torch.evals.run_all pointing --ann gt.pkl --pred p.pkl \
        [--segment_key segment_groundingyoutube_idx]
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=["vidstg", "anet", "pointing"])
    p.add_argument("--ann", required=True)
    p.add_argument("--pred", required=True)
    p.add_argument("--segment_key", default="segment_groundingyoutube_idx")
    p.add_argument("--fps", default=5.0, type=float)
    args = p.parse_args(argv)

    with open(args.pred, "rb") as f:
        pred = pickle.load(f)

    if args.task == "vidstg":
        from .vidstg import evaluate_vidstg
        with open(args.ann) as f:
            anns = json.load(f)
        gt = {}
        for v in anns["videos"]:
            vid = str(v["video_id"])
            if vid not in pred:
                continue
            traj = anns["trajectories"][v["original_video_id"]][
                str(v["target_id"])]
            fids = pred[vid]["frame_ids"]
            boxes = []
            for fid in fids:
                rec = traj.get(str(fid))
                if rec:
                    x, y, w, h = rec["bbox"]
                    boxes.append([x, y, x + w, y + h])
                else:
                    boxes.append([])
            gt[vid] = {"frame_ids": fids, "boxes": boxes}
        metrics = evaluate_vidstg(pred, gt)
    elif args.task == "anet":
        from .anet import gen_grounding_f1, gt_localization_accuracy
        with open(args.ann) as f:
            ref = json.load(f)
        metrics = gt_localization_accuracy(pred, ref)
        metrics.pop("per_class", None)
        metrics.update(gen_grounding_f1(pred, ref))
    else:
        from .pointing import pointing_accuracy
        with open(args.ann, "rb") as f:
            gt_data = pickle.load(f)
        acc, correct, valid = pointing_accuracy(pred, gt_data,
                                                args.segment_key)
        metrics = {"pointing_accuracy": acc, "correct": correct,
                   "valid": valid}

    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics


if __name__ == "__main__":
    main()
