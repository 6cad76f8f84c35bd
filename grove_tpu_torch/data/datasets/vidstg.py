"""VidSTG spatio-temporal grounding dataset adapter.

Copy of `grove_tpu/data/datasets/vidstg.py`, held equal to it by
`tests/test_torch_data.py`.

Annotation schema: one JSON (`dataset/video_grounding_datasets/VidSTG.py`)
  {"videos": [{video_id, original_video_id, video_path, caption, qtype,
               tube_start_frame, tube_end_frame, fps, width, height,
               target_id}],
   "trajectories": {original_video_id: {target_id: {frame_id: {"bbox":
               [x, y, w, h]}}}}}

The whole caption is a single grounded phrase (`VidSTG.py:119-135`):
answer = "<p> caption </p> [DET]"; one box per frame where the trajectory is
annotated; objectness = box-present (the reference trains VidSTG with the
objectness head disabled, `train.py`: use_temp_objectness only for
HowToGround).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .base import ClipAnnotation, GroundingVideoDataset


def parse_vidstg_video(video_info: Dict, trajectories: Dict,
                       video_dir: str, fps: float = 5.0) -> ClipAnnotation:
    w = int(video_info["width"])
    h = int(video_info["height"])
    video_fps = float(video_info["fps"])
    caption = video_info["caption"].strip()
    traj = trajectories[video_info["original_video_id"]][
        str(video_info["target_id"])]

    rate = max(int(video_fps / fps), 1)
    frame_ids = list(range(video_info["tube_start_frame"],
                           video_info["tube_end_frame"] - 1, rate))
    frame_boxes: List[np.ndarray] = []
    frame_obj: List[np.ndarray] = []
    for fid in frame_ids:
        rec = traj.get(str(fid))
        if rec is not None:
            x, y, bw, bh = rec["bbox"]
            box = np.array([[x, y, x + bw, y + bh]], np.float32)
            box[:, 0::2] = np.clip(box[:, 0::2], 0, w)
            box[:, 1::2] = np.clip(box[:, 1::2], 0, h)
            valid = (box[0, 2] > box[0, 0]) and (box[0, 3] > box[0, 1])
            frame_boxes.append(box if valid
                               else np.zeros((0, 4), np.float32))
            frame_obj.append(np.array([1.0 if valid else 0.0], np.float32))
        else:
            frame_boxes.append(np.zeros((0, 4), np.float32))
            frame_obj.append(np.array([0.0], np.float32))

    return ClipAnnotation(
        video_path=os.path.join(video_dir, video_info["video_path"]),
        caption=caption,
        phrases=[caption],
        tokens_positive=[(0, len(caption))],
        frame_boxes=frame_boxes,
        frame_objectness=frame_obj,
        width=w, height=h, fps=video_fps,
        clip_start_frame=video_info["tube_start_frame"],
        clip_end_frame=video_info["tube_end_frame"] - 1,
    )


class VidSTGDataset(GroundingVideoDataset):
    def __init__(self, ann_path: str, video_dir: str, **kw):
        super().__init__(**kw)
        with open(ann_path) as f:
            self.annotations = json.load(f)
        self.video_dir = video_dir

    def __len__(self):
        return len(self.annotations["videos"])

    def load_annotation(self, index: int) -> ClipAnnotation:
        return parse_vidstg_video(self.annotations["videos"][index],
                                  self.annotations["trajectories"],
                                  self.video_dir, self.fps)

    def qtype(self, index: int) -> str:
        return self.annotations["videos"][index].get("qtype", "declarative")

    def video_id(self, index: int) -> str:
        return str(self.annotations["videos"][index]["video_id"])

    def __getitem__(self, index: int):
        s = self.build_sample(self.load_annotation(index))
        s["qtype"] = self.qtype(index)
        return s
