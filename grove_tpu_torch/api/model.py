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

`save_pretrained(dir)` writes the port's model directory: `config.json`
(`GroveConfig.save_json`) and `STATE_FILE`, the model's own `state_dict()`
under the port's module names, quantized buffers and static activation
scales included. `from_pretrained(dir)` reads it back, and also what the
JAX package writes: its model directory (`config.json` and
`flax_model.msgpack`, `grove_tpu/api/model.py:190-199`: float, quantized,
calibrated, fused or with LoRA, read by `checkpoint.flax_msgpack` and
`checkpoint.convert.load_jax_tree`) and a training log directory, the
port's or an Orbax one (`checkpoint.manager.CheckpointManager`: best,
else latest). `checkpoint.flax_msgpack.save_jax_pretrained(lm, dir)`
writes the JAX package's model directory from a port model.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import GroveConfig
from ..checkpoint.convert import load_jax_tree, load_reference_state_dict
from ..checkpoint.peft import normalize_peft_state_dict
from ..models.grove import GroveModel, init_grove_params
from ..models.fuse import fuse_llama_
from ..ops.int8_matmul import column_major
from ..ops.quant import (calibrate_vision_, quantize_llama_,
                         quantize_vision_, set_llm_act_quant_)
from ..text.tokenizer import special_token_ids_from

_SIZES = {"tiny": GroveConfig.tiny, "small": GroveConfig.small,
          "full": GroveConfig}
# the port's model file in a `save_pretrained` directory: a torch state dict
# under the port's module names, not a reference `.bin`
STATE_FILE = "grove_torch_state_dict.pt"


def read_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference torch state dict file as `from_pretrained` reads it, the
    JAX package's way (`grove_tpu/api/model.py:76-86`): every tensor as
    fp32 numpy, PEFT names stripped and LoRA pairs merged
    (`checkpoint.peft.normalize_peft_state_dict`)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return normalize_peft_state_dict(
        {k: v.float().numpy() for k, v in sd.items() if hasattr(v, "numpy")})


def _column_major_int8(model) -> None:
    """Give each column-major int8 weight its `column_major` storage back
    (`to_empty` allocates it dense, without the room for a 2-D weight's N
    padding that `ops.int8_matmul` reads in place)."""
    for mod in model.modules():
        kq = getattr(mod, "kernel_q", None)
        if (isinstance(kq, torch.Tensor) and kq.dim() == 2
                and kq.t().is_contiguous() and not kq.is_contiguous()):
            mod.kernel_q = column_major(kq)


class GroveForCausalLM:
    def __init__(self, cfg: GroveConfig, model: GroveModel):
        self.cfg = cfg
        self.model = model

    @classmethod
    def from_pretrained(cls, checkpoint: Optional[str] = None,
                        model_size: str = "full", tokenizer=None,
                        dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        device="cuda") -> "GroveForCausalLM":
        """Fresh weights from `seed` (checkpoint=None), a directory
        (`_from_dir`: a model directory of the port's or the JAX package's
        `save_pretrained`, or a training log directory, the port's or an
        Orbax one), or a strict load
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
            return cls._from_dir(checkpoint, model_size, tokenizer, dtype,
                                 seed, device)
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

    @classmethod
    def _from_dir(cls, path: str, model_size: str, tokenizer, dtype, seed,
                  device) -> "GroveForCausalLM":
        """The directory dispatch of `api/model.py:34-86`. A model
        directory (`config.json` beside `STATE_FILE` or the JAX package's
        `flax_model.msgpack`) builds its own config on `device` (meta,
        then `to_empty`) in `dtype` and loads strictly (`load_jax_tree` for
        the JAX file). A training log directory (`CheckpointManager`: the
        port's `state.pt` steps or Orbax ones) loads its best parameters,
        else its latest, into the `model_size` config (fresh weights from
        `seed` where it holds neither, as JAX's)."""
        from ..checkpoint.flax_msgpack import MODEL_FILE, load
        from ..checkpoint.manager import CheckpointManager
        tree = sd = None
        if os.path.isfile(os.path.join(path, "config.json")):
            cfg = GroveConfig.load_json(os.path.join(path, "config.json"))
            if os.path.isfile(os.path.join(path, STATE_FILE)):
                sd = torch.load(os.path.join(path, STATE_FILE),
                                map_location="cpu", weights_only=True,
                                mmap=True)
            elif os.path.isfile(os.path.join(path, MODEL_FILE)):
                tree = load(os.path.join(path, MODEL_FILE))
            else:
                raise FileNotFoundError(f"{path}: config.json without "
                                        f"{STATE_FILE} or {MODEL_FILE}")
        else:
            written = [os.path.join(path, d, s) for d, s in (
                ("ckpt_model", ""), ("ckpt_model_best", "params"))]
            if not any(os.path.isdir(d) for d in written):
                raise FileNotFoundError(
                    f"{path}: neither a model directory (config.json) nor "
                    "a training log directory (ckpt_model/, "
                    "ckpt_model_best/)")
            mgr = CheckpointManager(path)
            restored = mgr.restore_best() or mgr.restore()
            if restored is None and any(
                    os.listdir(d) for d in written if os.path.isdir(d)):
                raise ValueError(f"{path}: its checkpoints hold no step "
                                 "the port or Orbax wrote")
            cfg = _SIZES[model_size]()
            sd = restored["params"] if restored else None
        if tokenizer is not None:
            cfg = dataclasses.replace(
                cfg, tokens=special_token_ids_from(tokenizer))
        if sd is None and tree is None:
            return cls(cfg, init_grove_params(cfg, device=device,
                                              dtype=dtype, seed=seed))
        model = GroveModel(cfg, device="meta", dtype=dtype)
        model = model.to_empty(device=device)
        if tree is not None:
            try:
                load_jax_tree(model, tree)
            except ValueError as e:
                raise ValueError(f"{os.path.join(path, MODEL_FILE)}: "
                                 f"{e}") from e
            del tree
        else:
            model.load_state_dict(sd, strict=True)
        _column_major_int8(model)
        return cls(model.cfg, model.eval())

    def save_pretrained(self, save_dir: str) -> None:
        """Write the port's model directory (`api/model.py:190-199`):
        `config.json` and `STATE_FILE`, the model's `state_dict()` on the
        CPU. `from_pretrained(save_dir, dtype=...)` with the model's dtype
        gives the same model back, quantized and fused ones included. The
        JAX package's layout is `checkpoint.flax_msgpack.
        save_jax_pretrained(self, save_dir)`."""
        from ..checkpoint.manager import to_cpu
        os.makedirs(save_dir, exist_ok=True)
        self.cfg.save_json(os.path.join(save_dir, "config.json"))
        torch.save(to_cpu(self.model.state_dict()),
                   os.path.join(save_dir, STATE_FILE))

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
