"""Host time of the main path's entry before the model: frames and the two
towers' preprocessing, per clip, on the CPU (no card needed).

    python3 -m grove_tpu_torch.profile_host [--root DIR] [--repeat N]

One clip as `GroveProcessor` reads it: 24 frames of 640 x 360 at 5 fps from
`SyntheticVideo` (in-memory frames, no decode; the size of the clips of
`chip_smoke.py` phase 3), then `data.preprocess.preprocess_frames` at the
full-width towers' sizes (CLIP 336, SAM 512). Prints the median wall time
of each over `--repeat` runs and the host's CPU count, then one JSON line.
`--root DIR` times the `grove_tpu_torch` found under DIR instead (an older
checkout), so that two versions compare in one process environment.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
        for name in [m for m in sys.modules if m.startswith("grove_tpu_torch")]:
            del sys.modules[name]
    from grove_tpu_torch.api import GroveProcessor
    from grove_tpu_torch.config import GroveConfig
    from grove_tpu_torch.data.preprocess import preprocess_frames
    from grove_tpu_torch.data.video import SyntheticVideo

    cfg = GroveConfig()
    proc = GroveProcessor(None, cfg, decoder_factory=lambda path: SyntheticVideo(
        num_frames=24, width=640, height=360, seed=20))
    frames_ms, prep_ms = [], []
    for _ in range(args.repeat + 1):              # the first run warms up
        t0 = time.perf_counter()
        frames = proc.decode_video("clip")
        t1 = time.perf_counter()
        preprocess_frames(frames, cfg.clip.image_size, cfg.sam_enc.img_size)
        t2 = time.perf_counter()
        frames_ms.append((t1 - t0) * 1e3)
        prep_ms.append((t2 - t1) * 1e3)
    out = {"package": os.path.dirname(sys.modules["grove_tpu_torch"].__file__),
           "frames": list(frames.shape), "cpus": os.cpu_count(),
           "synthetic_frames_ms": statistics.median(frames_ms[1:]),
           "preprocess_ms": statistics.median(prep_ms[1:]),
           "repeat": args.repeat}
    print(f"{out['package']}: {out['frames']} frames, SyntheticVideo "
          f"{out['synthetic_frames_ms']:.1f} ms, preprocess_frames "
          f"{out['preprocess_ms']:.1f} ms per clip (median of "
          f"{args.repeat}, {out['cpus']} CPUs)")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
