"""LoRA utilities: fold the adapters into their base projections.

Counterpart of `grove_tpu/tools/merge_lora.py` (reference
`scripts/merge_lora_weights.py`): after LoRA training, every `q_proj_lora`
/ `v_proj_lora` adapter (`models.llama.LoraDelta`) is folded into its base
weight as W += (B @ A) * alpha / r and dropped, so that inference and
checkpoints need no adapter. `normalize_peft_state_dict`, for PEFT-named
torch files, is the one of `checkpoint/peft.py`, re-exported here.

    python -c "from grove_tpu_torch.tools.merge_lora import \\
        merge_lora_params; merge_lora_params(model)"
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..checkpoint.peft import normalize_peft_state_dict
from ..config import GroveConfig
from ..models.llama import LlamaModel, set_llama_cfg_

__all__ = ["merge_lora_params", "normalize_peft_state_dict"]

_ADAPTED = ("q_proj", "v_proj")


def _merged(weight, lora_a, lora_b, scaling: float, name: str):
    """weight (out, in) + (lora_b (out, r) @ lora_a (r, in)) * scaling, in
    fp32, back in the weight's dtype."""
    weight, lora_a, lora_b = (torch.as_tensor(t) for t in (weight, lora_a,
                                                          lora_b))
    if not weight.is_floating_point():
        raise ValueError(f"{name}: a LoRA adapter merges into a float "
                         f"weight only, not {weight.dtype}")
    delta = (lora_b.float() @ lora_a.float()) * scaling
    return (weight.float() + delta).to(weight.dtype)


def _merge_model(model: nn.Module) -> nn.Module:
    """In place: every adapter of `model` folded into its `nn.Linear`; the
    config's `lora_r` becomes 0 once none is left."""
    for mname, mod in model.named_modules():
        for name in _ADAPTED:
            delta = getattr(mod, name + "_lora", None)
            if delta is None:
                continue
            base = getattr(mod, name, None)
            where = f"{mname}.{name}"
            if type(base) is not nn.Linear:
                raise ValueError(
                    f"{where}: a LoRA adapter merges into a float "
                    f"nn.Linear only, not {type(base).__name__} (quantized "
                    f"or fused projections keep their adapters)")
            with torch.no_grad():
                base.weight.copy_(_merged(base.weight, delta.lora_A.weight,
                                          delta.lora_B.weight,
                                          delta.scaling, where))
            delattr(mod, name + "_lora")
    stack = getattr(model, "model", model)
    if isinstance(stack, LlamaModel):
        llama = dataclasses.replace(stack.llama_cfg, lora_r=0)
        set_llama_cfg_(stack, llama)
        if isinstance(getattr(model, "cfg", None), GroveConfig):
            model.cfg = dataclasses.replace(model.cfg, llama=llama)
    return model


def _merge_state_dict(sd: Dict, alpha: float, r: int) -> Dict:
    """A new state dict: each `*.{q,v}_proj_lora.lora_{A,B}.weight` pair
    folded into `*.{q,v}_proj.weight` and dropped."""
    out = dict(sd)
    for key in sd:
        if not key.endswith("_lora.lora_A.weight"):
            continue
        stem = key[:-len("_lora.lora_A.weight")]
        base = stem + ".weight"
        if base not in sd:
            raise ValueError(f"{key}: no float base weight {base} (a fused "
                             f"or quantized projection)")
        out[base] = _merged(sd[base], out.pop(key),
                            out.pop(stem + "_lora.lora_B.weight"),
                            alpha / r, base)
    return out


def merge_lora_params(target, alpha: Optional[float] = None,
                      r: Optional[int] = None):
    """Fold the LoRA adapters of the port's model (in place, scaled by each
    adapter's own alpha / r; returns the model) or of a state dict in the
    port's names (a new dict; `alpha` and `r` required, as the JAX
    function takes them, `merge_lora.py:16-40`). Raises on a projection
    that is not a float `nn.Linear`: int4, W8A8 and fused projections
    cannot take the delta."""
    if isinstance(target, nn.Module):
        return _merge_model(target)
    if alpha is None or r is None:
        raise ValueError("merging a state dict needs alpha and r")
    return _merge_state_dict(target, alpha, r)
