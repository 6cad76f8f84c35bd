"""GroveForCausalLM: one object bundling a config and a model.

Counterpart of `grove_tpu/api/model.py:25-172`, with the parts the
quantized serving slices need:

    lm = GroveForCausalLM.from_pretrained(None, "full", seed=0)  # on cuda
    # W4A8 LLM, W8A8 towers: the JAX package's serving configuration
    lm = lm.quantize(bits=4, vision=True, act_quant=True)
    lm = lm.calibrate(clip_frames, sam_frames)  # static act scales
    infer_clips_batched(lm.model, lm.cfg, tokenizer, clips,
                        decode_kwargs={"cache_dtype": torch.int8})

`quantize`, `calibrate` and `fuse` work IN PLACE on the one model (a
full-width model quantizes on the card without a second copy of the
weights), where the JAX methods return a new instance beside the old one.
The HF-layout / Orbax directory loaders and `save_pretrained` raise,
naming their ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..config import GroveConfig
from ..checkpoint.convert import load_reference_state_dict
from ..models.grove import GroveModel, init_grove_params
from ..models.fuse import fuse_llama_
from ..ops.quant import (calibrate_vision_, quantize_llama_,
                         quantize_vision_, set_llm_act_quant_)

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
                        device="cuda") -> "GroveForCausalLM":
        """Fresh weights from `seed` (checkpoint=None), or a strict load
        of a reference torch state dict file (reference names; the key
        families in `checkpoint.convert.SKIP_PATTERNS` are dropped), built
        directly on `device` (the card unless the caller asks for another)
        in `dtype`."""
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
