"""Synthetic dataset generation: annotation files + tiny clips.

Counterpart of `grove_tpu/data/synthetic.py`: a directory in the exact
HowTo100M / iGround (and VidSTG, ActivityNet-Entities, pointing) layout,
so the data pipeline and the training driver run end to end without real
data. The JAX package writes each clip as an animated GIF through PIL; the
port has neither PIL nor, on the card's machine, libav, so it writes the
same frames (a seeded random image rolled 5 pixels a frame) as a `.npy`
clip with its fps beside it (`data.video.write_npy_clip`, read by
`data.video.NpyVideo`). The seeded generator is drawn from in the JAX
order, so a seed gives the same annotations; only the clip files' names
end in `.npy` where JAX's end in `.gif`.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from .video import write_npy_clip

_OBJECTS = ["a red block", "the green ball", "a blue cup", "the yellow box"]
_VERBS = ["moves past", "touches", "circles around", "bumps into"]


CLIP_EXT = ".npy"


def clip_frames(num_frames: int, width: int, height: int,
                rng) -> np.ndarray:
    """The JAX package's synthetic frames (`synthetic.py:23-31`) before
    any GIF palette: (num_frames, height, width, 3) uint8."""
    base = rng.integers(0, 128, size=(height, width, 3), dtype=np.uint8)
    return np.stack([np.roll(base, shift=5 * i, axis=1)
                     for i in range(num_frames)])


def _make_clip(path: str, num_frames: int, width: int, height: int,
               fps: float, rng) -> None:
    write_npy_clip(path, clip_frames(num_frames, width, height, rng), fps)


def make_synthetic_howto_dataset(root: str, num_videos: int = 4,
                                 num_frames: int = 16, width: int = 96,
                                 height: int = 64, fps: float = 5.0,
                                 seed: int = 0) -> Tuple[str, str, List[str]]:
    """Create ann_dir + video_dir with `num_videos` synthetic clips.

    Returns (ann_dir, video_dir, keys)."""
    rng = np.random.default_rng(seed)
    ann_dir = os.path.join(root, "annotations")
    video_dir = os.path.join(root, "videos")
    os.makedirs(ann_dir, exist_ok=True)
    os.makedirs(video_dir, exist_ok=True)
    keys = []
    for v in range(num_videos):
        vid = f"vid{v:04d}"
        keys.append(vid)
        fname = f"{vid}{CLIP_EXT}"
        _make_clip(os.path.join(video_dir, fname), num_frames, width, height,
                   fps, rng)

        n_phrases = int(rng.integers(1, 3))
        objs = list(rng.choice(len(_OBJECTS), size=n_phrases, replace=False))
        phrases = [_OBJECTS[i] for i in objs]
        verb = _VERBS[int(rng.integers(len(_VERBS)))]
        if n_phrases == 1:
            caption = f"{phrases[0]} {verb} the table"
        else:
            caption = f"{phrases[0]} {verb} {phrases[1]}"
        tagged = caption
        for ph in sorted(phrases, key=len, reverse=True):
            tagged = tagged.replace(ph, f"<p>{ph}</p>")

        bboxes, labels = [], []
        for f in range(num_frames):
            fb, fl = [], []
            for pi, ph in enumerate(phrases):
                visible = rng.uniform() > 0.3
                if visible:
                    x1 = float(rng.uniform(0, width / 2))
                    y1 = float(rng.uniform(0, height / 2))
                    fb.append([x1, y1, x1 + float(rng.uniform(8, width / 2)),
                               y1 + float(rng.uniform(8, height / 2))])
                    fl.append(ph)
            bboxes.append(fb)
            labels.append(fl)

        ann = {
            "video_fname": fname,
            "fps": fps,
            "clip_start_frame": 0,
            "clip_end_frame": num_frames - 1,
            "width": width,
            "height": height,
            "caption": caption,
            "tagged_caption": tagged,
            "phrases": phrases,
            "bboxes": bboxes,
            "labels": labels,
        }
        with open(os.path.join(ann_dir, f"{vid}.pkl"), "wb") as f:
            pickle.dump(ann, f)
    return ann_dir, video_dir, keys


def make_synthetic_vidstg(root: str, num_videos: int = 2,
                          num_frames: int = 24, width: int = 96,
                          height: int = 64, fps: float = 5.0,
                          seed: int = 0):
    """VidSTG-layout JSON + clips. Returns (ann_path, video_dir)."""
    import json
    rng = np.random.default_rng(seed)
    video_dir = os.path.join(root, "vidstg_videos")
    os.makedirs(video_dir, exist_ok=True)
    videos, trajectories = [], {}
    for v in range(num_videos):
        vid = f"stg{v:04d}"
        ovid = f"orig_{vid}"
        fname = f"{vid}{CLIP_EXT}"
        _make_clip(os.path.join(video_dir, fname), num_frames, width, height,
                   fps, rng)
        qtype = "declarative" if v % 2 == 0 else "interrogative"
        videos.append({
            "video_id": vid, "original_video_id": ovid,
            "video_path": fname,
            "caption": f"{_OBJECTS[v % len(_OBJECTS)]} moving around",
            "qtype": qtype,
            "tube_start_frame": 0, "tube_end_frame": num_frames,
            "fps": fps, "width": width, "height": height, "target_id": 1,
        })
        traj = {}
        for f in range(num_frames):
            if rng.uniform() > 0.2:
                x = float(rng.uniform(0, width / 2))
                y = float(rng.uniform(0, height / 2))
                traj[str(f)] = {"bbox": [x, y,
                                         float(rng.uniform(10, width / 2)),
                                         float(rng.uniform(10, height / 2))]}
        trajectories[ovid] = {"1": traj}
    ann_path = os.path.join(root, "vidstg.json")
    with open(ann_path, "w") as f:
        json.dump({"videos": videos, "trajectories": trajectories}, f)
    return ann_path, video_dir


def make_synthetic_pointing(root: str, num_clips: int = 2,
                            num_frames: int = 20, width: int = 96,
                            height: int = 64, fps: float = 5.0,
                            seed: int = 0,
                            segment_key: str = "segment_groundingyoutube_idx",
                            secs_key: str = "secs_absolute"):
    """GroundingYouTube/YouCook-layout annotation pickle + clips.

    Returns (ann_path, video_dir, gt_data) where gt_data is the eval-side
    list (with segment_bboxes)."""
    import pickle as pkl
    rng = np.random.default_rng(seed)
    video_dir = os.path.join(root, "pointing_videos")
    os.makedirs(video_dir, exist_ok=True)
    anns, gt_data = [], []
    for v in range(num_clips):
        vid = f"pt{v:04d}"
        fname = f"{vid}{CLIP_EXT}"
        _make_clip(os.path.join(video_dir, fname), num_frames, width, height,
                   fps, rng)
        pts = [i / fps for i in range(num_frames)]
        target_secs = [float(pts[num_frames // 4]),
                       float(pts[num_frames // 2])]
        anns.append({
            "video_id": vid, segment_key: 0, "video_fname": fname,
            "caption": _OBJECTS[v % len(_OBJECTS)],
            "pts": pts, secs_key: target_secs, "fps": fps,
            "width": width, "height": height,
        })
        boxes = []
        for _ in target_secs:
            x = float(rng.uniform(0, width / 2))
            y = float(rng.uniform(0, height / 2))
            boxes.append((x, y, x + float(rng.uniform(10, width / 2)),
                          y + float(rng.uniform(10, height / 2))))
        gt_data.append({"video_id": vid, "segment_idx": 0,
                        segment_key.replace("segment_", "segment_"): 0,
                        "segment_bboxes": boxes})
    ann_path = os.path.join(root, "pointing.pkl")
    with open(ann_path, "wb") as f:
        pkl.dump(anns, f)
    return ann_path, video_dir, gt_data


def make_synthetic_anet(root: str, num_videos: int = 2,
                        num_frames: int = 40, width: int = 96,
                        height: int = 64, fps: float = 5.0, seed: int = 0):
    """ActivityNet-Entities-layout JSON + frame-timestamps + clips.

    Returns (ann_path, video_dir, frame_timestamps)."""
    import json
    rng = np.random.default_rng(seed)
    video_dir = os.path.join(root, "anet_videos")
    os.makedirs(video_dir, exist_ok=True)
    anns, frame_ts = {}, {}
    for v in range(num_videos):
        vid = f"v_anet{v:04d}"
        _make_clip(os.path.join(video_dir, f"{vid}{CLIP_EXT}"), num_frames,
                   width, height, fps, rng)
        duration = num_frames / fps
        stored_ts = [i / fps for i in range(num_frames)]
        frame_ts[vid] = stored_ts
        labels = [_OBJECTS[v % len(_OBJECTS)].split()[-1],
                  _OBJECTS[(v + 1) % len(_OBJECTS)].split()[-1]]
        tokens = ["someone", "moves", labels[0], "near", "the", labels[1]]
        boxes, fidx, pidx = [], [], []
        for li, lab in enumerate(labels):
            x = float(rng.uniform(0, width / 2))
            y = float(rng.uniform(0, height / 2))
            boxes.append([x, y, x + float(rng.uniform(10, width / 2)),
                          y + float(rng.uniform(10, height / 2))])
            fidx.append(int(rng.integers(0, 10)))
            pidx.append([tokens.index(lab)])
        anns[vid] = {
            "fps": fps, "num_frames": num_frames, "duration": duration,
            "segments": {
                "0": {
                    "tokens": tokens,
                    "process_clss": [[l] for l in labels],
                    "process_bnd_box": boxes,
                    "frame_ind": fidx,
                    "process_idx": pidx,
                    "timestamps": [0.5, duration - 1.0],
                }
            },
        }
    ann_path = os.path.join(root, "anet.json")
    with open(ann_path, "w") as f:
        json.dump(anns, f)
    return ann_path, video_dir, frame_ts
