"""Public inference API: one call, video in -> grounded caption out.

Counterpart of `grove_tpu/api/processor.py` (the reference's
`grove_transformers.GroveProcessor`, `processing_grove.py:263-432`): decode
the clip (the native libav decoder, `data.video.VideoDecoder`, at 5 fps),
preprocess it for both towers on the host (`data.preprocess`, numpy,
bit-equal to the JAX package's PIL transforms), and run the sliding-window
pipeline (`infer.sliding`), returning the reference's output dict:

  {text, text_tagged, phrases, center_frame_indices, frame_indices, bboxes,
   labels_per_frame, probs_temp_objectness, original_size}

    proc = GroveProcessor(tokenizer, lm.cfg)
    out = proc.generate(lm.model, "clip.mp4")

The model argument is the port's `GroveModel` (it holds its weights: there
is no separate `variables`). `temperature > 0` samples, seeded by `seed`
(a `torch.Generator` on the model's device); `num_beams > 1` runs beam
search. `generate_with_backend` hands the center window's decode to a
backend, the continuous-batching serving engine's
(`serve.continuous.ContinuousService`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import GroveConfig
from ..data.preprocess import preprocess_frames
from ..data.video import VideoDecoder
from ..infer.sliding import infer_clip, infer_clips_batched
from ..text.prompts import VIDEO_GROUNDING_QUESTIONS

KV_CACHE_DTYPES = {None: torch.bfloat16, "bf16": torch.bfloat16,
                   "bfloat16": torch.bfloat16, "int8": torch.int8,
                   "fp32": torch.float32, "float32": torch.float32}


def _decode_kwargs(kv_cache_dtype: Optional[str], early_stop: bool,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 1.0, seed: Optional[int] = None,
                   num_beams: int = 1, length_penalty: float = 1.0,
                   device=None) -> Dict:
    """Map user-facing strings to the decode kwargs of
    `infer.sliding.infer_clips_batched(..., decode_kwargs=...)`; the same
    checks as the JAX function (`processor.py:25-66`), whose table is
    copied here with torch dtypes. A seed with sampling becomes a
    `torch.Generator` on `device` (the CPU when None)."""
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype must be one of "
                         f"{sorted(k for k in KV_CACHE_DTYPES if k)}, "
                         f"got {kv_cache_dtype!r}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0 < top_p <= 1:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 1 <= num_beams <= 16:
        raise ValueError(f"num_beams must be in [1, 16], got {num_beams}")
    if temperature == 0 and (top_k > 0 or top_p < 1):
        raise ValueError("top_k/top_p only apply to sampling; "
                         "set temperature > 0")
    if num_beams > 1 and temperature > 0:
        raise ValueError("num_beams > 1 is deterministic; "
                         "drop temperature or use num_beams=1")
    if num_beams > 1 and kv_cache_dtype == "int8":
        raise ValueError("num_beams > 1 requires a reorderable KV cache; "
                         "use kv_cache_dtype='bf16' or 'fp32'")
    out = {"cache_dtype": KV_CACHE_DTYPES[kv_cache_dtype],
           "early_exit": bool(early_stop),
           "temperature": float(temperature), "top_k": int(top_k),
           "top_p": float(top_p), "num_beams": int(num_beams),
           "length_penalty": float(length_penalty)}
    # a seed without sampling is inert: drop it, so that identical greedy
    # requests stay batchable (the serving layer groups by knob values)
    if seed is not None and temperature > 0:
        out["generator"] = torch.Generator(
            device=device or "cpu").manual_seed(int(seed))
    return out


DEFAULT_INSTRUCTION = VIDEO_GROUNDING_QUESTIONS[0]


class GroveProcessor:
    def __init__(self, tokenizer, cfg: GroveConfig, fps: float = 5.0,
                 decoder_factory=VideoDecoder):
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.fps = fps
        self.decoder_factory = decoder_factory

    def decode_video(self, video_path: str,
                     start_frame: Optional[int] = None,
                     end_frame: Optional[int] = None,
                     video_fps: Optional[float] = None,
                     max_frames: int = 1024) -> np.ndarray:
        """All frames at self.fps (the reference decodes the full clip at 5
        fps, `processing_grove.py:195-261`); optional frame-range crop."""
        with self.decoder_factory(video_path) as dec:
            src_fps = video_fps or dec.fps or self.fps
            if start_frame is not None and end_frame is not None:
                rate = max(int(src_fps / self.fps), 1)
                ts = [i / src_fps
                      for i in range(start_frame, end_frame + 1, rate)]
                return dec.decode_at(ts)
            return dec.decode_fps(self.fps, max_frames=max_frames)

    def _sample(self, video_path: str, *decode) -> Dict:
        """Decode one clip and preprocess it for both towers (float32,
        normalized) -> a sample of `infer_clips_batched`."""
        frames = self.decode_video(video_path, *decode)
        if frames.size == 0:
            raise ValueError(f"No frames decoded from {video_path}")
        fc, fs = preprocess_frames(frames, self.cfg.clip.image_size,
                                   self.cfg.sam_enc.img_size)
        return {"frames_clip": fc, "frames_sam": fs,
                "original_size": (frames.shape[2], frames.shape[1])}

    def generate(self, model, video_path: str,
                 instruction: Optional[str] = None,
                 max_new_tokens: int = 64,
                 temp_objectness_threshold: Optional[float] = None,
                 start_frame: Optional[int] = None,
                 end_frame: Optional[int] = None,
                 video_fps: Optional[float] = None,
                 kv_cache_dtype: Optional[str] = None,
                 early_stop: bool = True, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: Optional[int] = None, num_beams: int = 1,
                 length_penalty: float = 1.0) -> Dict:
        """One clip -> the reference's output dict. `kv_cache_dtype`:
        None / 'bf16' (default), 'int8' or 'fp32'; `early_stop` ends the
        decode once every sequence emitted EOS (identical ids).
        `temperature` > 0 samples with optional `top_k` / nucleus `top_p`
        truncation, seeded by `seed`; `num_beams` > 1 runs beam search
        (deterministic; `length_penalty` normalizes the final scores)."""
        s = self._sample(video_path, start_frame, end_frame, video_fps)
        return infer_clip(
            model, self.cfg, self.tokenizer, s["frames_clip"],
            s["frames_sam"], s["original_size"], instruction=instruction,
            max_new_tokens=max_new_tokens,
            threshold=temp_objectness_threshold,
            decode_kwargs=_decode_kwargs(kv_cache_dtype, early_stop,
                                         temperature, top_k, top_p, seed,
                                         num_beams, length_penalty,
                                         model.device))

    def generate_with_backend(self, model, video_path: str, decode_backend,
                              instruction: Optional[str] = None,
                              temp_objectness_threshold=None,
                              start_frame=None, end_frame=None,
                              video_fps=None) -> Dict:
        """`generate` with the center window's decode handed to
        `decode_backend` (`infer.sliding.infer_clip`'s argument; the
        continuous-batching engine supplies one). Greedy semantics; the
        knobs live in the backend."""
        s = self._sample(video_path, start_frame, end_frame, video_fps)
        return infer_clip(
            model, self.cfg, self.tokenizer, s["frames_clip"],
            s["frames_sam"], s["original_size"], instruction=instruction,
            threshold=temp_objectness_threshold,
            decode_backend=decode_backend)

    def generate_batch(self, model, video_paths, instructions=None,
                       max_new_tokens: int = 64,
                       temp_objectness_threshold: Optional[float] = None,
                       kv_cache_dtype: Optional[str] = None,
                       early_stop: bool = True, temperature: float = 0.0,
                       top_k: int = 0, top_p: float = 1.0,
                       seed: Optional[int] = None, num_beams: int = 1,
                       length_penalty: float = 1.0):
        """`generate` over several clips, their center windows generated in
        one batch. `instructions`: None (the default prompt), one string,
        or one per clip (unequal prompts are left-padded and decoded in
        lockstep). Returns one output dict per clip, in input order."""
        samples = [self._sample(vp) for vp in video_paths]
        return infer_clips_batched(
            model, self.cfg, self.tokenizer, samples,
            instruction=instructions, max_new_tokens=max_new_tokens,
            threshold=temp_objectness_threshold,
            decode_kwargs=_decode_kwargs(kv_cache_dtype, early_stop,
                                         temperature, top_k, top_p, seed,
                                         num_beams, length_penalty,
                                         model.device))
