"""Experiment DAG runner: infer -> eval in one command.

Counterpart of `grove_tpu/tools/run_experiment.py` (the reference's SLURM
dependency chain, `infer_eval_scripts/infer_eval_iground.sh:23-31`:
embed_tokens -> infer -> eval). The embedding table is part of the model's
weights (no embed_tokens stage), and a `--version` `.bin` is loaded by the
infer driver. Stage 1 is the port's `infer.drivers.main`, stage 2 the
port's evals, on rank 0 of `torch.distributed` only (rank 0 when it is not
initialized). `--synthetic` writes the task's synthetic set (`.npy` clips)
into the workdir, so that the eval stage has its ground truth. `--device`
(default `cuda`) goes to the infer driver.

    python -m grove_tpu_torch.tools.run_experiment --task anet --synthetic \\
        --model_size tiny --device cpu --workdir out/
"""

from __future__ import annotations

import argparse
import os

TASKS = ["iground", "vidstg", "anet", "groundingyoutube",
         "youcookinteractions"]


def _make_synthetic(args) -> None:
    """Write the task's synthetic set INTO the workdir (not the infer
    driver's temporary directory), with the pointing tasks' ground truth
    as a pickle beside it."""
    import pickle
    from ..infer.drivers import make_synthetic

    root = os.path.join(args.workdir, "synthetic")
    os.makedirs(root, exist_ok=True)
    args.ann_dir, args.video_dir, fts, gt_data = make_synthetic(args.task,
                                                                root)
    args.frame_timestamps = fts or args.frame_timestamps
    if gt_data is not None:
        gt_path = os.path.join(root, "pointing_gt.pkl")
        with open(gt_path, "wb") as f:
            pickle.dump(gt_data, f)
        args.gt = args.gt or gt_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="iground", choices=TASKS)
    p.add_argument("--model_size", default="tiny")
    p.add_argument("--version", default=None)
    p.add_argument("--ann_dir", default=None,
                   help="annotation dir (iground) or file (other tasks)")
    p.add_argument("--video_dir", default=None)
    p.add_argument("--frame_timestamps", default=None,
                   help="frame-timestamps json (anet task)")
    p.add_argument("--gt", default=None,
                   help="eval ground truth (defaults to --ann_dir)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--workdir", default="./experiment")
    p.add_argument("--max_new_tokens", default=64, type=int)
    p.add_argument("--device", default="cuda",
                   help="the infer driver's device (cuda or cpu)")
    args = p.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    pred_path = os.path.join(args.workdir, f"{args.task}_predictions.pkl")
    if args.synthetic:
        _make_synthetic(args)

    # stage 1: inference
    from ..infer.drivers import main as infer_main
    infer_args = ["--task", args.task, "--model_size", args.model_size,
                  "--output", pred_path,
                  "--max_new_tokens", str(args.max_new_tokens),
                  "--device", args.device]
    if args.version:
        infer_args += ["--version", args.version]
    if args.ann_dir:
        infer_args += ["--ann_dir", args.ann_dir]
    if args.video_dir:
        infer_args += ["--video_dir", args.video_dir]
    if args.frame_timestamps:
        infer_args += ["--frame_timestamps", args.frame_timestamps]
    infer_main(infer_args)

    # stage 2: evaluation
    gt = args.gt or args.ann_dir
    if gt is None:
        print("no ground truth available; skipping eval stage")
        return
    from ..data.loader import process_rank_world
    if process_rank_world()[0] != 0:
        return
    if args.task == "iground":
        from ..evals.run_iground import main as eval_main
        return eval_main(["--ann_dir", gt,
                          "--video_dir", args.video_dir or "",
                          "--pred", pred_path])
    from ..evals.run_all import main as eval_main
    if args.task == "vidstg":
        return eval_main(["vidstg", "--ann", gt, "--pred", pred_path])
    if args.task == "anet":
        return eval_main(["anet", "--ann", gt, "--pred", pred_path])
    from ..infer.drivers import pointing_keys
    return eval_main(["pointing", "--ann", gt, "--pred", pred_path,
                      "--segment_key", pointing_keys(args.task)[0]])


if __name__ == "__main__":
    main()
