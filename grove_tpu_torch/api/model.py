"""GroveForCausalLM: one object bundling a config and a model.

Counterpart of `grove_tpu/api/model.py:25-172`, with the parts the
quantized serving slices need:

    lm = GroveForCausalLM.from_pretrained(None, "full", device="cuda",
                                          seed=0)
    lm = lm.quantize(bits=4, vision=True)   # int4 LLM, W8A8 towers
    lm = lm.calibrate(clip_frames, sam_frames)  # static act scales
    infer_clips_batched(lm.model, lm.cfg, tokenizer, clips,
                        decode_kwargs={"cache_dtype": torch.int8})

`quantize` and `calibrate` work IN PLACE on the one model (a full-width
model quantizes on the card without a second copy of the weights), where
the JAX methods return a new instance beside the old one. `act_quant`,
`fuse`, the HF-layout / Orbax directory loaders and `save_pretrained`
raise, each naming its ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from grove_tpu.config import GroveConfig

from ..checkpoint.convert import load_reference_state_dict
from ..models.grove import GroveModel, init_grove_params
from ..ops.quant import calibrate_vision_, quantize_llama_, quantize_vision_

_SIZES = {"tiny": GroveConfig.tiny, "small": GroveConfig.small,
          "full": GroveConfig}


class GroveForCausalLM:
    def __init__(self, cfg: GroveConfig, model: GroveModel):
        self.cfg = cfg
        self.model = model

    @classmethod
    def from_pretrained(cls, checkpoint: Optional[str] = None,
                        model_size: str = "full",
                        dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        device="cpu") -> "GroveForCausalLM":
        """Fresh weights from `seed` (checkpoint=None), or a strict load
        of a reference torch state dict file (reference names; the key
        families in `checkpoint.convert.SKIP_PATTERNS` are dropped), built
        directly on `device` in `dtype`."""
        if checkpoint is not None and os.path.isdir(checkpoint):
            raise NotImplementedError(
                "HF-layout (flax_model.msgpack) and Orbax checkpoint "
                "directories are not ported yet (ROADMAP Queue 1 item 14, "
                "checkpoint I/O)")
        cfg = _SIZES[model_size]()
        if checkpoint is None:
            model = init_grove_params(cfg, device=device, dtype=dtype,
                                      seed=seed)
        else:
            sd = torch.load(checkpoint, map_location="cpu",
                            weights_only=True)
            model = GroveModel(cfg, device="meta", dtype=dtype)
            model = load_reference_state_dict(
                model.to_empty(device=device), sd).eval()
        return cls(cfg, model)

    def quantize(self, vision: bool = False, bits: int = 8,
                 act_quant: bool = False) -> "GroveForCausalLM":
        """Serving quantization, in place: the LLM's projections become
        per-channel int8 (bits=8, W8A16) or group-128 int4 (bits=4, W4A16),
        lm_head per-channel int8 either way; with `vision=True` the CLIP and
        SAM towers also become W8A8 (int8 weights, dynamic int8
        activations until `calibrate`). Returns this instance, whose `cfg`
        now has `weight_quant=True` (and the towers' `quant_w8a8=True`)."""
        if act_quant:
            raise NotImplementedError(
                "quantize(act_quant=True): W4A8 / W8A8 LLM activations are "
                "not ported yet (ROADMAP Queue 1 item 11b)")
        quantize_llama_(self.model, bits, group=self.cfg.llama.quant_group)
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

    def fuse(self):
        raise NotImplementedError(
            "fuse: fused qkv / gate_up projections are not ported yet "
            "(ROADMAP Queue 1 item 11b)")

    def save_pretrained(self, save_dir: str):
        raise NotImplementedError(
            "save_pretrained is not ported yet (ROADMAP Queue 1 item 14, "
            "checkpoint I/O)")
