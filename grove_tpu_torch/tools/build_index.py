"""Build a dataset key manifest for streaming-scale training.

One-time replacement for the per-start annotation-directory walk the
reference does implicitly (`dataset/video_grounding_datasets/HowTo100M.py:57-60`
operates on a listing of per-video pickles). At HowToGround1M scale the walk
is minutes per host per restart; the manifest makes startup a sequential
read and lets each host load only its shard (`data/index.py`). A copy of
`grove_tpu/tools/build_index.py` over the port's copy of the index.

Usage:
    python -m grove_tpu_torch.tools.build_index \
        --ann_dir /data/howtoground/ann --output /data/howtoground/manifest.txt
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Build dataset key manifest")
    p.add_argument("--ann_dir", required=True,
                   help="directory of per-video annotation pickles")
    p.add_argument("--output", required=True, help="manifest output path")
    p.add_argument("--suffix", default=".pkl")
    args = p.parse_args(argv)

    from ..data.index import build_manifest
    n = build_manifest(args.ann_dir, args.output, suffix=args.suffix)
    print(f"wrote {n} keys to {args.output}")


if __name__ == "__main__":
    main()
