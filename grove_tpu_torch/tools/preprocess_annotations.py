"""Split a monolithic annotation pickle into per-video pickles (a copy of
`grove_tpu/tools/preprocess_annotations.py`).

Equivalent of `scripts/preprocess_howtoground_annot.py:1-46`: the training
datasets read one pickle per video id (`HowTo100M.py:57-60`); this tool
converts the distributed monolithic {video_id: ann_dict} pickle into that
layout.

Run: python -m grove_tpu_torch.tools.preprocess_annotations \
        --input all_annotations.pkl --output_dir annotations/
"""

from __future__ import annotations

import argparse
import os
import pickle


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True)
    p.add_argument("--output_dir", required=True)
    args = p.parse_args(argv)

    with open(args.input, "rb") as f:
        annotations = pickle.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    for video_id, ann in annotations.items():
        with open(os.path.join(args.output_dir, f"{video_id}.pkl"),
                  "wb") as f:
            pickle.dump(ann, f)
    print(f"wrote {len(annotations)} per-video pickles to {args.output_dir}")


if __name__ == "__main__":
    main()
