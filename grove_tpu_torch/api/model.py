"""GroveForCausalLM: one object bundling a config and a model.

Counterpart of `grove_tpu/api/model.py:25-172`, with the parts the
quantized serving slices need:

    lm = GroveForCausalLM.from_pretrained(None, "full", seed=0)  # on cuda
    # W4A8 LLM, W8A8 towers: the JAX package's serving configuration
    lm = lm.quantize(bits=4, vision=True, act_quant=True)
    lm = lm.calibrate(clip_frames, sam_frames)  # static act scales
    infer_clips_batched(lm.model, lm.cfg, tokenizer, clips,
                        decode_kwargs={"cache_dtype": torch.int8})

The reference's mode-multiplexed surface (`encode_images`,
`get_grounding_encoder_embs`, `get_dense_pe`, `forward_train`,
`forward_boxes`, `evaluate`, `generate_clip`) wraps the `GroveModel`
methods, as `api/model.py:204-239` does. `quantize`, `calibrate` and
`fuse` work IN PLACE on the one model (a
full-width model quantizes on the card without a second copy of the
weights), where the JAX methods return a new instance beside the old one.
The HF-layout / Orbax directory loaders and `save_pretrained` raise,
naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import GroveConfig
from ..checkpoint.convert import load_reference_state_dict
from ..checkpoint.peft import normalize_peft_state_dict
from ..models.grove import GroveModel, init_grove_params
from ..models.fuse import fuse_llama_
from ..ops.quant import (calibrate_vision_, quantize_llama_,
                         quantize_vision_, set_llm_act_quant_)
from ..text.tokenizer import special_token_ids_from

_SIZES = {"tiny": GroveConfig.tiny, "small": GroveConfig.small,
          "full": GroveConfig}


def read_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference torch state dict file as `from_pretrained` reads it, the
    JAX package's way (`grove_tpu/api/model.py:76-86`): every tensor as
    fp32 numpy, PEFT names stripped and LoRA pairs merged
    (`checkpoint.peft.normalize_peft_state_dict`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return normalize_peft_state_dict(
        {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")})


class GroveForCausalLM:
    def __init__(self, cfg: GroveConfig, model: GroveModel):
        self.cfg = cfg
        self.model = model

    @classmethod
    def from_pretrained(cls, checkpoint: Optional[str] = None,
                        model_size: str = "full", tokenizer=None,
                        dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        device="cuda") -> "GroveForCausalLM":
        """Fresh weights from `seed` (checkpoint=None), or a strict load
        of a reference torch state dict file, built directly on `device`
        (the card unless the caller asks for another) in `dtype`. The file
        goes the JAX package's way (`grove_tpu/api/model.py:76-86`): its
        tensors as fp32 numpy, PEFT names stripped and LoRA pairs merged
        (`read_checkpoint`), the key families in
        `checkpoint.convert.SKIP_PATTERNS` dropped, SAM's tables on another
        grid resized; then a missing or unknown key raises. With a
        `tokenizer`, the special-token ids of the config come from it
        (`text.tokenizer.special_token_ids_from`), as JAX's do
        (`api/model.py:48-52`)."""
        if checkpoint is not None and os.path.isdir(checkpoint):
            raise NotImplementedError(
                "HF-layout (flax_model.msgpack) and Orbax checkpoint "
                "directories are not ported yet (ROADMAP Queue 1 item 14, "
                "checkpoint I/O)")
        cfg = _SIZES[model_size]()
        if tokenizer is not None:
            cfg = dataclasses.replace(
                cfg, tokens=special_token_ids_from(tokenizer))
        if checkpoint is None:
            model = init_grove_params(cfg, device=device, dtype=dtype,
                                      seed=seed)
        else:
            model = GroveModel(cfg, device="meta", dtype=dtype)
            model = load_reference_state_dict(
                model.to_empty(device=device),
                read_checkpoint(checkpoint)).eval()
        return cls(cfg, model)

    def quantize(self, vision: bool = False, bits: int = 8,
                 act_quant: bool = False) -> "GroveForCausalLM":
        """Serving quantization, in place (`api/model.py:89-133`): the
        LLM's projections become per-channel int8 (bits=8) or group-128
        int4 (bits=4), lm_head per-channel int8 either way; with
        `act_quant` their activations are quantized per token too (W8A8 /
        W4A8: the int8 GEMM at prefill, K7b at decode); with `vision=True`
        the CLIP and SAM towers also become W8A8 (dynamic int8 activations
        until `calibrate`). On an LLM already quantized at these bits only
        `act_quant` is switched (`ops.quant.set_llm_act_quant_`): the
        weights stay as they are. Returns this instance, whose `cfg` has
        `weight_quant=True` and `act_quant` (and the towers'
        `quant_w8a8=True`)."""
        llama = self.cfg.llama
        if llama.weight_quant:
            if llama.weight_quant_bits != bits:
                raise ValueError(f"quantize(bits={bits}): the LLM is already "
                                 f"quantized to {llama.weight_quant_bits} "
                                 "bits")
            set_llm_act_quant_(self.model, act_quant)
        else:
            quantize_llama_(self.model, bits, group=llama.quant_group,
                            act_quant=act_quant)
        if vision:
            quantize_vision_(self.model)
        self.cfg = self.model.cfg
        return self

    def calibrate(self, clip_frames, sam_frames,
                  margin: float = 1.0) -> "GroveForCausalLM":
        """Static activation scales for the W8A8 towers, in place: one
        dynamic-mode forward of each tower on representative frames
        ((B, T, H, W, 3), uint8 at the tower's size or normalized) records
        the absmax of every quant site, absmax / 127 * margin is installed,
        and both towers switch to `quant_static_act=True`. Raises
        ValueError unless the instance came from `quantize(vision=True)`."""
        calibrate_vision_(self.model, clip_frames, sam_frames, margin)
        self.cfg = self.model.cfg
        return self

    def fuse(self) -> "GroveForCausalLM":
        """Fused qkv / gate_up projections, in place (`models.fuse`,
        `api/model.py:174-188`): fewer, wider matmuls per LLaMA layer, the
        same numbers up to the order of K7a's and K7b's split sums on the
        card. Composes with `quantize` in either order. Returns this
        instance, whose `cfg` has `fused_qkv=True`."""
        fuse_llama_(self.model)
        self.cfg = self.model.cfg
        return self

    def save_pretrained(self, save_dir: str):
        raise NotImplementedError(
            "save_pretrained is not ported yet (ROADMAP Queue 1 item 14, "
            "checkpoint I/O)")

    # ------------------------------------------------------------------
    # mode-multiplexed surface (reference `model/GROVE.py:138-154`)
    # ------------------------------------------------------------------

    def _on_model(self, x):
        """numpy arrays and tensors onto the model's device."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.model.device)

    @torch.inference_mode()
    def encode_images(self, frames_clip):
        """CLIP tower + projector -> (video tokens, mlvl features)."""
        return self.model.encode_video(self._on_model(frames_clip))

    @torch.inference_mode()
    def get_grounding_encoder_embs(self, frames_sam):
        """SAM encoder (chunked over frames) -> (B*T, HW, C)."""
        return self.model.encode_grounding_auto(self._on_model(frames_sam))

    @torch.inference_mode()
    def get_dense_pe(self):
        return self.model.dense_pe()

    def _batch(self, batch: Dict):
        return {k: (v if k == "video_start" else self._on_model(v))
                for k, v in batch.items()}

    def forward_train(self, batch: Dict):
        """The loss dict of one batch (`GroveModel.forward_train`); runs
        with the caller's grad mode, so a training step can differentiate
        it."""
        return self.model.forward_train(self._batch(batch))

    @torch.inference_mode()
    def forward_boxes(self, batch: Dict):
        """Teacher-forced boxes and objectness logits."""
        return self.model.forward_boxes(self._batch(batch))

    def evaluate(self, tokenizer, spliced_ids, video_start, frames_clip,
                 frames_sam, max_new_tokens: int = 64):
        """Grounded generation on prepared ids and frames
        (`infer.generate.generate_grounded`)."""
        from ..infer.generate import generate_grounded
        return generate_grounded(self.model, self.cfg, tokenizer,
                                 spliced_ids, video_start, frames_clip,
                                 frames_sam, max_new_tokens=max_new_tokens)

    def generate_clip(self, tokenizer, video_path: str, **kw):
        """One video file -> the output dict (`GroveProcessor.generate`)."""
        from .processor import GroveProcessor
        return GroveProcessor(tokenizer, self.cfg).generate(
            self.model, video_path, **kw)
