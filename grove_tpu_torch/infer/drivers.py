"""Batch inference drivers: dataset -> per-clip grounded predictions.

Counterpart of `grove_tpu/infer/drivers.py` (the reference's
`infer_iground.py`, `infer_vidstg.py`, `infer_anet.py` and
`infer_groundingyoutube.py`): every rank processes its shard of clips through
the sliding-window pipeline (`infer.sliding`), the results are merged across
ranks and deduplicated by clip id (`infer_iground.py:87-108,290-295`), and
rank 0 writes the predictions pickle the evals (`evals/`) read. The five
tasks, their datasets and the pickles' structure are the JAX driver's:

* iground: `run_inference`, generation from the center window of every
  clip, clips in groups of `clip_batch` whose center windows decode in one
  batch, the next groups' clips decoded and their center windows uploaded
  by a prefetch thread (`center_stacks` on a side CUDA stream, handed over
  through `infer_clips_batched(preloaded=)`), and the `timing` dict per
  group (`wait_s`, `load_s`, `upload_s`, `model_s`);
* vidstg, groundingyoutube, youcookinteractions: `run_caption_grounding`,
  the given caption teacher-forced over every window;
* anet: `run_anet_inference`, generation on frames 0-7, then frames 8 and 9
  from the teacher-forced windows [1, 9) and [2, 10), and the official
  submission structure.

Where it differs from the JAX driver:

* the clips are read through `data.video.open_video` (libav files and the
  `.npy` clips that `--synthetic` writes, readable on a machine without
  libav); `--device_preprocess yuv` on an odd-sized source raises the
  decoder's ValueError (JAX asserts, `grove_tpu/data/video.py:128`);
* `--device` (default `cuda`; no fallback to the CPU) and the model built
  there from `--seed` (`models.grove.init_grove_params`: fp32 for `tiny`,
  bf16 otherwise, `drivers.py:398`); the teacher-forced passes run
  `model.forward_boxes` under `torch.inference_mode()`;
* a `--version` path that does not exist raises FileNotFoundError (JAX
  skips it and runs on random weights, `drivers.py:401`), and the keys the
  `.bin` leaves missing or mismatched are printed by name beside the count
  of tensors loaded (JAX merges them silently, `:408`);
* the rank and the world size are `torch.distributed`'s when it is
  initialized, else 0 and 1 (`data.loader.process_rank_world`), and
  `gather_outputs` is `all_gather_object` followed by the first-occurrence
  merge.

    python -m grove_tpu_torch.infer.drivers --task vidstg --synthetic \\
        --model_size tiny --device cpu --output /tmp/preds.pkl
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import GroveConfig
from ..data.loader import process_rank_world
from ..data.preprocess import preprocess_frames, preprocess_frames_uint8
from ..data.video import open_video
from .sliding import (_window_batch, center_stacks, ground_clip_with_caption,
                      infer_clips_batched, postprocess_window)

TASKS = ("iground", "vidstg", "groundingyoutube", "youcookinteractions",
         "anet")
CAPTION_TASKS = ("vidstg", "groundingyoutube", "youcookinteractions")


def pointing_keys(task: str):
    """(segment key, target-seconds key) of a pointing task's annotations."""
    if task == "groundingyoutube":
        return "segment_groundingyoutube_idx", "secs_absolute"
    return "segment_youcookinteractions_idx", "secs_relative"


class FullClipIGroundDataset:
    """Inference-time dataset: ALL frames at eval fps, no temporal sampling
    (`infer_iground.py:320-435`). `device_preprocess`: False resizes on the
    host (uint8 frames at the towers' sizes, normalized on the device);
    True ships one raw RGB stack, "yuv" the packed YUV420 planes, resized
    and normalized on the device (`GroveModel._norm_*`)."""

    def __init__(self, ann_dir: str, video_dir: str, cfg: GroveConfig,
                 fps: float = 5.0, keys: Optional[List[str]] = None,
                 decoder_factory=open_video, max_frames: int = 512,
                 device_preprocess=False):
        from ..data.datasets.howto100m import parse_howto_annotation
        self._parse = parse_howto_annotation
        self.ann_dir = ann_dir
        self.video_dir = video_dir
        self.cfg = cfg
        self.fps = fps
        self.decoder_factory = decoder_factory
        self.max_frames = max_frames
        self.device_preprocess = device_preprocess
        if keys is None:
            keys = sorted(os.path.splitext(f)[0]
                          for f in os.listdir(ann_dir) if f.endswith(".pkl"))
        self.keys = list(keys)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> Dict:
        with open(os.path.join(self.ann_dir, f"{self.keys[index]}.pkl"),
                  "rb") as f:
            ann_info = pickle.load(f)
        ann = self._parse(ann_info, self.video_dir)
        rate = max(int(ann.fps / self.fps), 1)
        ids = list(range(ann.clip_start_frame, ann.clip_end_frame + 1, rate))
        ts = [i / ann.fps for i in ids][:self.max_frames]
        out = {
            "original_size": (ann.width, ann.height),
            "video_id": self.keys[index],
            "clip_id": 0,
            "ann": ann,
        }
        with self.decoder_factory(ann.video_path) as dec:
            if self.device_preprocess == "yuv":
                frames = dec.decode_at_yuv(ts)
            else:
                frames = dec.decode_at(ts)
        if self.device_preprocess:
            # one raw array under both keys (the same object): the towers
            # resize it on the device and it is uploaded once
            out["frames_clip"] = out["frames_sam"] = frames
            return out
        frames_clip, frames_sam, valid = preprocess_frames_uint8(
            frames, self.cfg.clip.image_size, self.cfg.sam_enc.img_size)
        out["frames_clip"] = frames_clip
        out["frames_sam"] = frames_sam
        out["sam_valid_hw"] = valid
        return out


class FullClipVidSTGDataset:
    """VidSTG inference: all tube frames at eval fps, caption given
    (`infer_vidstg.py:388-493`)."""

    def __init__(self, ann_path: str, video_dir: str, cfg: GroveConfig,
                 fps: float = 5.0, decoder_factory=open_video,
                 max_frames: int = 512):
        import json
        with open(ann_path) as f:
            self.annotations = json.load(f)
        self.video_dir = video_dir
        self.cfg = cfg
        self.fps = fps
        self.decoder_factory = decoder_factory
        self.max_frames = max_frames

    def __len__(self):
        return len(self.annotations["videos"])

    def __getitem__(self, index: int) -> Dict:
        from ..data.datasets.vidstg import parse_vidstg_video
        vinfo = self.annotations["videos"][index]
        ann = parse_vidstg_video(vinfo, self.annotations["trajectories"],
                                 self.video_dir, self.fps)
        rate = max(int(ann.fps / self.fps), 1)
        ids = list(range(ann.clip_start_frame, ann.clip_end_frame, rate))
        ids = ids[:self.max_frames]
        ts = [i / ann.fps for i in ids]
        with self.decoder_factory(ann.video_path) as dec:
            frames = dec.decode_at(ts)
        frames_clip, frames_sam = preprocess_frames(
            frames, self.cfg.clip.image_size, self.cfg.sam_enc.img_size)
        return {
            "frames_clip": frames_clip, "frames_sam": frames_sam,
            "original_size": (ann.width, ann.height),
            "video_id": str(vinfo["video_id"]),
            "qtype": vinfo.get("qtype", "declarative"),
            "caption": ann.caption,
            "frame_ids": ids,
        }


class FullClipPointingDataset:
    """GroundingYouTube / YouCook-Interactions inference: caption given,
    frames at annotation pts resampled to eval fps
    (`infer_groundingyoutube.py:287-330`)."""

    def __init__(self, ann_path: str, video_dir: str, cfg: GroveConfig,
                 fps: float = 5.0, decoder_factory=open_video,
                 segment_key: str = "segment_groundingyoutube_idx",
                 secs_key: str = "secs_absolute"):
        with open(ann_path, "rb") as f:
            self.annotations = pickle.load(f)
        self.video_dir = video_dir
        self.cfg = cfg
        self.fps = fps
        self.decoder_factory = decoder_factory
        self.segment_key = segment_key
        self.secs_key = secs_key

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, index: int) -> Dict:
        video = self.annotations[index]
        path = os.path.join(self.video_dir, video["video_fname"])
        rate = max(int(video["fps"] / self.fps), 1)
        pts = list(video["pts"])[::rate]
        if list(video["pts"])[-1] not in pts:
            pts.append(list(video["pts"])[-1])
        with self.decoder_factory(path) as dec:
            frames = dec.decode_at(pts)
        frames_clip, frames_sam = preprocess_frames(
            frames, self.cfg.clip.image_size, self.cfg.sam_enc.img_size)
        return {
            "frames_clip": frames_clip, "frames_sam": frames_sam,
            "original_size": (video["width"], video["height"]),
            "video_id": f"{video['video_id']}_{video[self.segment_key]}",
            "caption": video["caption"],
            "sampled_pts": pts,
            "target_secs": list(video[self.secs_key]),
        }


class FullClipANetDataset:
    """10 segment-midpoint frames per segment, caption to be generated
    (`infer_anet.py:111-121` works on these 10 frames)."""

    def __init__(self, ann_path: str, video_dir: str,
                 frame_timestamps, cfg: GroveConfig,
                 decoder_factory=open_video, target_width: int = 720):
        from ..data.datasets.anet_entities import ActivityNetEntitiesDataset
        self.ds = ActivityNetEntitiesDataset(
            ann_path, video_dir, frame_timestamps, decoder_factory,
            num_frames=cfg.num_frames, clip_size=cfg.clip.image_size,
            sam_size=cfg.sam_enc.img_size, max_phrases=cfg.max_phrases,
            validation=True, target_width=target_width)
        self.cfg = cfg

    def __len__(self):
        return len(self.ds.segment_map)

    def __getitem__(self, index: int) -> Dict:
        from ..data.datasets.anet_entities import compute_midpoint_timestamps
        video_id, segment_id = self.ds.segment_map[index]
        ann = self.ds.parse_segment(video_id, segment_id)
        start, end = ann["timestamps"]
        end = min(end, self.ds.frame_timestamps[video_id][-2])
        midpoints = compute_midpoint_timestamps(start, end, 10)
        frames, w, h = self.ds.decode_frames(video_id, midpoints)
        frames_clip, frames_sam = preprocess_frames(
            frames, self.cfg.clip.image_size, self.cfg.sam_enc.img_size)
        return {
            "frames_clip": frames_clip, "frames_sam": frames_sam,
            "original_size": (w, h), "video_id": video_id,
            "segment_id": segment_id, "caption_gt": ann["caption"],
        }


def run_caption_grounding(dataset, model, cfg: GroveConfig, tokenizer, *,
                          task: str, rank: int = 0, world: int = 1,
                          progress: bool = True) -> Dict:
    """Caption-given grounding over a dataset shard (vidstg / pointing)."""
    from ..text.prompts import VIDEO_STG_QUESTIONS
    question = VIDEO_STG_QUESTIONS[0] if task == "vidstg" else None
    outputs: Dict[str, Dict] = {}
    for i in range(rank, len(dataset), world):
        t0 = time.time()
        s = dataset[i]
        out = ground_clip_with_caption(
            model, cfg, tokenizer, s["frames_clip"], s["frames_sam"],
            s["original_size"], caption=s["caption"], question=question,
            use_objectness=False)
        if task == "vidstg":
            outputs[s["video_id"]] = {
                "frame_ids": s["frame_ids"],
                "boxes": out["bboxes"],
                "qtype": s["qtype"],
            }
        else:
            # each target second takes the box of the closest sampled pts
            # (`infer_groundingyoutube.py:216-219`)
            pts = s["sampled_pts"]
            pts_to_bbox = {p: b for p, b in zip(pts, out["bboxes"])}
            final_boxes, selected = [], []
            for sec in s["target_secs"]:
                closest = min(pts, key=lambda p: abs(p - sec))
                final_boxes.append(pts_to_bbox[closest])
                selected.append(closest)
            outputs[s["video_id"]] = {
                "pts_to_bbox": pts_to_bbox,
                "final_boxes": final_boxes,
                "selected_pts": selected,
            }
        if progress:
            print(f"[{rank}] {task} clip {s['video_id']}: "
                  f"{time.time() - t0:.1f}s", flush=True)
    return outputs


def update_and_sort_video_outputs(gathered: List[Dict]) -> Dict:
    """Merge per-rank result dicts, first occurrence wins
    (`infer_iground.py:87-108`)."""
    out = {}
    for results in gathered:
        for clip_id, data in results.items():
            if clip_id not in out:
                out[clip_id] = data
    return out


def run_inference(dataset, model, cfg: GroveConfig, tokenizer, *,
                  max_new_tokens: int = 64, rank: int = 0, world: int = 1,
                  progress: bool = True, clip_batch: int = 4,
                  decode_kwargs: Optional[Dict] = None,
                  timing: Optional[List] = None) -> Dict:
    """Per-rank sliding-window inference over the dataset shard.

    Clips are processed in groups of `clip_batch`: the fixed-prompt
    center-window generation batches across the group, then each clip's
    remaining windows run in one batched pass. A thread pool loads the
    next two groups ahead (decode + preprocess), and uploads their center
    windows (`center_stacks`; on the card on a CUDA stream of its own) so
    that the upload overlaps this group's compute.

    `timing`, if given, collects one dict per group: `wait_s` (the stall
    on the prefetch future: host decode and upload not hidden under device
    compute), `model_s` (batched generate + window passes + host
    postprocess), and the prefetch thread's own `load_s` (decode +
    preprocess) and `upload_s` (the center stacks' upload) for the
    group."""
    video_outputs: Dict[str, Dict] = {}
    my_indices = list(range(rank, len(dataset), world))
    groups = [my_indices[g:g + clip_batch]
              for g in range(0, len(my_indices), clip_batch)]
    device = model.device
    stream = (torch.cuda.Stream(device=device) if device.type == "cuda"
              else None)

    def load_group(idxs):
        t0 = time.time()
        samples = [dataset[i] for i in idxs]
        t1 = time.time()
        pre = center_stacks(samples, cfg.num_frames, device, stream)
        return samples, pre, t1 - t0, time.time() - t1

    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = [pool.submit(load_group, g) for g in groups[:2]]
        for gi in range(len(groups)):
            t0 = time.time()
            samples, pre, load_s, upload_s = futures[gi].result()
            t_wait = time.time() - t0
            if gi + 2 < len(groups):
                futures.append(pool.submit(load_group, groups[gi + 2]))
            outs = infer_clips_batched(model, cfg, tokenizer, samples,
                                       max_new_tokens=max_new_tokens,
                                       decode_kwargs=decode_kwargs,
                                       preloaded=pre)
            if timing is not None:
                timing.append({"wait_s": t_wait, "load_s": load_s,
                               "upload_s": upload_s,
                               "model_s": time.time() - t0 - t_wait})
            for sample, out in zip(samples, outs):
                uid = f"{sample['video_id']}_{sample['clip_id']}"
                video_outputs[uid] = {
                    "pred_bboxes": out["bboxes"],
                    "pred_labels": out["labels_per_frame"],
                    "pred_phrases": out["phrases"],
                    "pred_text": out["text"],
                    "pred_text_tagged": out["text_tagged"],
                    "probs_temp_objectness": out["probs_temp_objectness"],
                    "original_size": out["original_size"],
                    "frame_indices": out["frame_indices"],
                }
            if progress:
                print(f"[{rank}] clips {[s['video_id'] for s in samples]}: "
                      f"{time.time() - t0:.1f}s", flush=True)
    return video_outputs


def gather_outputs(video_outputs: Dict) -> Dict:
    """All-gather per-rank result dicts across ranks (the reference's
    `dist.all_gather_object`, `infer_iground.py:290-293`), then merge them
    first occurrence first. One process: the dict as it is."""
    import torch.distributed as dist
    _, world = process_rank_world()
    if world == 1:
        return video_outputs
    gathered = [None] * world
    dist.all_gather_object(gathered, video_outputs)
    return update_and_sort_video_outputs(gathered)


def _phrase_word_indices(caption: str, phrases: List[str]) -> List[int]:
    """First-word index of each phrase in the caption (idx_in_sent)."""
    words = caption.lower().split()
    out = []
    for ph in phrases:
        first = ph.lower().split()[0] if ph.split() else ""
        idx = next((i for i, wd in enumerate(words) if first and first in wd),
                   -1)
        out.append(idx)
    return out


def _packed_prompt(cfg: GroveConfig, tokenizer, answer=None):
    """The grounding prompt (with `answer` as the assistant's turn) packed
    at its own spliced length, as `drivers.py:495-503,537-545` pack it."""
    from ..text.packing import pack_text
    from ..text.prompts import grounding_prompt, tokenize_with_video
    ids = tokenize_with_video(grounding_prompt(answer=answer), tokenizer)
    return pack_text(ids, None, tokenizer,
                     num_video_tokens=cfg.num_video_tokens,
                     max_spliced_len=len(ids) - 1 + cfg.num_video_tokens,
                     det_token_id=cfg.tokens.det,
                     max_phrases=cfg.max_phrases,
                     pad_id=tokenizer.pad_token_id, with_labels=False)


@torch.inference_mode()
def run_anet_inference(dataset, model, cfg: GroveConfig, tokenizer, *,
                       max_new_tokens: int = 64, rank: int = 0,
                       world: int = 1, progress: bool = True,
                       decode_kwargs: Optional[Dict] = None) -> Dict:
    """Sliding windows [0-8), [1-9), [2-10): generate on window 0, box-only
    passes for frames 8 and 9 (`infer_anet.py:111-292`). Emits the official
    submission structure {vid: {seg: {clss, idx_in_sent,
    bbox_for_all_frames}}} (and each segment's `pred_text`)."""
    from ..text import tagging
    from .generate import generate_grounded

    nf = cfg.num_frames
    outputs: Dict[str, Dict] = {}
    for i in range(rank, len(dataset), world):
        t0 = time.time()
        s = dataset[i]
        fc_all, fs_all = s["frames_clip"], s["frames_sam"]
        w0 = list(range(0, nf))
        packed = _packed_prompt(cfg, tokenizer)
        gen = generate_grounded(
            model, cfg, tokenizer, packed.input_ids[None].astype(np.int64),
            np.asarray([packed.video_start], np.int64), fc_all[w0][None],
            fs_all[w0][None], max_new_tokens=max_new_tokens,
            **(decode_kwargs or {}))
        gen_ids = [int(t) for t in gen["generated_ids"][0]
                   if t != cfg.tokens.pad]
        raw = tokenizer.decode(gen_ids, skip_special_tokens=False)
        text_output = raw.replace("\n", "").replace("  ", " ")
        if "ASSISTANT: " in text_output:
            text_output = text_output.split("ASSISTANT: ")[-1]
        # generic markup repair (the reference's hand-written per-string
        # fix-up table for malformed ANet generations,
        # `infer_anet.py:194-213`); text only, the boxes stay as generated
        text_output = tagging.repair_generation(text_output)
        parsed = tagging.parse_generation(text_output)
        phrases = parsed["phrases"]
        num_dets = int(gen["phrase_mask"][0].sum())

        boxes_by_frame, _, _ = postprocess_window(
            gen["pred_boxes"][0],
            None,                       # keep every det box per frame
            phrases, num_dets, s["original_size"], 0.0)

        # frames 8, 9 via the teacher-forced windows [1-9) and [2-10)
        if num_dets > 0:
            ap = _packed_prompt(cfg, tokenizer, answer=text_output)
            extra_windows = [list(range(1, nf + 1)),
                             list(range(2, nf + 2))]
            out = model.forward_boxes(_window_batch(
                model, fc_all, fs_all, extra_windows, ap))
            pb = out["pred_boxes"].float().cpu().numpy()
            n_tf = int(ap.phrase_mask.sum())
            for wi in range(len(extra_windows)):
                wb, _, _ = postprocess_window(pb[wi], None, phrases, n_tf,
                                              s["original_size"], 0.0)
                boxes_by_frame.append(wb[-1])   # last frame = nf + wi
        else:
            boxes_by_frame.extend([np.zeros((0, 4), np.float32)] * 2)

        # per-object 10-frame box lists
        n_obj = min(num_dets, len(phrases))
        bbox_for_all_frames = []
        for oi in range(n_obj):
            per_frame = []
            for f in range(10):
                fb = boxes_by_frame[f] if f < len(boxes_by_frame) else \
                    np.zeros((0, 4), np.float32)
                per_frame.append(fb[oi].tolist() if oi < len(fb)
                                 else [0.0, 0.0, 0.0, 0.0])
            bbox_for_all_frames.append(per_frame)

        vid = s["video_id"]
        outputs.setdefault(vid, {})[s["segment_id"]] = {
            "clss": phrases[:n_obj],
            "idx_in_sent": _phrase_word_indices(parsed["text"],
                                                phrases[:n_obj]),
            "bbox_for_all_frames": bbox_for_all_frames,
            "pred_text": parsed["text"],
        }
        if progress:
            print(f"[{rank}] anet {vid}/{s['segment_id']}: "
                  f"{time.time() - t0:.1f}s", flush=True)
    return outputs


def make_synthetic(task: str, root: str, **kw):
    """The port's synthetic set of `task` under `root` (`.npy` clips; `kw`
    goes to the task's maker in `data.synthetic`): (ann_dir or annotation
    file, video dir, frame-timestamps json path or None, the pointing
    tasks' ground truth or None)."""
    from ..data import synthetic
    if task == "iground":
        ann, videos, _ = synthetic.make_synthetic_howto_dataset(root, **kw)
        return ann, videos, None, None
    if task == "vidstg":
        ann, videos = synthetic.make_synthetic_vidstg(root, **kw)
        return ann, videos, None, None
    if task == "anet":
        import json
        ann, videos, fts = synthetic.make_synthetic_anet(root, **kw)
        fts_path = os.path.join(root, "fts.json")
        with open(fts_path, "w") as f:
            json.dump(fts, f)
        return ann, videos, fts_path, None
    key, secs = pointing_keys(task)
    ann, videos, gt = synthetic.make_synthetic_pointing(
        root, segment_key=key, secs_key=secs, **kw)
    return ann, videos, None, gt


def build_model(args, cfg: GroveConfig, device: torch.device):
    """The driver's model: `cfg` on `device`, fp32 for `tiny` and bf16
    otherwise (`drivers.py:398`, the training driver's `model_dtype`),
    seeded weights built there, then the `--version` `.bin` laid over
    them."""
    from ..models.grove import init_grove_params
    from ..train.driver import load_version, model_dtype
    model = init_grove_params(cfg, device=device,
                              dtype=model_dtype(args.model_size),
                              seed=args.seed)
    if args.version:
        if not os.path.exists(args.version):
            raise FileNotFoundError(f"--version {args.version}: no such "
                                    "checkpoint")
        copied, missing, mismatched = load_version(model, args.version)
        print(f"loaded {copied} tensors from {args.version}; missing "
              f"{len(missing)}: {missing}; mismatched {len(mismatched)}: "
              f"{mismatched}", flush=True)
    return model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GROVE batch inference "
                                            "(PyTorch)")
    p.add_argument("--task", default="iground", choices=list(TASKS))
    p.add_argument("--frame_timestamps", default=None,
                   help="frame-timestamps json (anet task)")
    p.add_argument("--model_size", default="tiny",
                   choices=["tiny", "small", "full"])
    p.add_argument("--version", default=None,
                   help="torch .bin checkpoint to load")
    p.add_argument("--ann_dir", default=None)
    p.add_argument("--video_dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--output", default="predictions.pkl")
    p.add_argument("--max_new_tokens", default=64, type=int)
    p.add_argument("--max_frames", default=512, type=int)
    p.add_argument("--device_preprocess", default="host",
                   choices=["host", "rgb", "yuv"],
                   help="iground only: ship raw RGB or native YUV420 "
                        "frames and resize/normalize on the device instead "
                        "of host preprocessing")
    p.add_argument("--seed", default=42, type=int)
    # decode knobs (generation-bearing tasks; the reference is greedy-only)
    p.add_argument("--num_beams", default=1, type=int)
    p.add_argument("--temperature", default=0.0, type=float)
    p.add_argument("--top_k", default=0, type=int)
    p.add_argument("--top_p", default=1.0, type=float)
    p.add_argument("--kv_cache_dtype", default=None,
                   choices=["bf16", "int8", "fp32"])
    p.add_argument("--no_early_stop", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    return p, p.parse_args(argv)


def main(argv=None):
    p, args = parse_args(argv)
    from ..api.processor import _decode_kwargs
    from ..train.driver import _device, build_tokenizer
    device = _device(args.device)
    try:
        dk = _decode_kwargs(args.kv_cache_dtype, not args.no_early_stop,
                            args.temperature, args.top_k, args.top_p,
                            args.seed if args.temperature > 0 else None,
                            args.num_beams, device=device)
    except ValueError as e:
        p.error(str(e))
    if args.task in CAPTION_TASKS and (
            args.num_beams > 1 or args.temperature > 0
            or args.kv_cache_dtype or args.no_early_stop):
        # these tasks ground a GIVEN caption: there is no generation (and
        # no KV-cache decode loop) for any of these flags to steer
        p.error(f"generation flags (--num_beams/--temperature/"
                f"--kv_cache_dtype/--no_early_stop) have no effect on "
                f"caption-given task {args.task!r}")

    cfg = {"tiny": GroveConfig.tiny, "small": GroveConfig.small,
           "full": GroveConfig}[args.model_size]()
    if args.synthetic:
        import tempfile
        root = tempfile.mkdtemp(prefix="grove_infer_")
        args.ann_dir, args.video_dir, fts, _ = make_synthetic(args.task,
                                                              root)
        args.frame_timestamps = fts or args.frame_timestamps

    from ..text.tokenizer import special_token_ids_from
    tokenizer = build_tokenizer(args, cfg)
    cfg = dataclasses.replace(cfg, tokens=special_token_ids_from(tokenizer))
    model = build_model(args, cfg, device)
    rank, world = process_rank_world()

    if args.task == "iground":
        dataset = FullClipIGroundDataset(
            args.ann_dir, args.video_dir, cfg, max_frames=args.max_frames,
            device_preprocess={"host": False, "rgb": True,
                               "yuv": "yuv"}[args.device_preprocess])
        outputs = run_inference(dataset, model, cfg, tokenizer,
                                max_new_tokens=args.max_new_tokens,
                                rank=rank, world=world, decode_kwargs=dk)
    elif args.task == "vidstg":
        dataset = FullClipVidSTGDataset(args.ann_dir, args.video_dir, cfg,
                                        max_frames=args.max_frames)
        outputs = run_caption_grounding(dataset, model, cfg, tokenizer,
                                        task="vidstg", rank=rank,
                                        world=world)
    elif args.task == "anet":
        import json
        with open(args.frame_timestamps) as f:
            fts = json.load(f)
        dataset = FullClipANetDataset(args.ann_dir, args.video_dir, fts, cfg)
        outputs = run_anet_inference(dataset, model, cfg, tokenizer,
                                     max_new_tokens=args.max_new_tokens,
                                     rank=rank, world=world,
                                     decode_kwargs=dk)
    else:
        key, secs = pointing_keys(args.task)
        dataset = FullClipPointingDataset(args.ann_dir, args.video_dir, cfg,
                                          segment_key=key, secs_key=secs)
        outputs = run_caption_grounding(dataset, model, cfg, tokenizer,
                                        task=args.task, rank=rank,
                                        world=world)
    outputs = gather_outputs(outputs)
    if rank == 0:
        with open(args.output, "wb") as f:
            pickle.dump(outputs, f)
        print(f"wrote {len(outputs)} clip predictions to {args.output}")
    return outputs


if __name__ == "__main__":
    main()
