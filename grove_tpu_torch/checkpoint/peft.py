"""PEFT-named state dicts: strip the adapter prefixes and merge LoRA pairs.

Copy of `normalize_peft_state_dict` (`grove_tpu/tools/merge_lora.py:43-68`),
which `GroveForCausalLM.from_pretrained` applies to a loaded `.bin` before
the strict load, as the JAX package does at `grove_tpu/api/model.py:83`
(that module imports jax, so the port keeps its own copy;
tests/test_torch_misc.py holds the two equal).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def normalize_peft_state_dict(sd: Dict[str, np.ndarray],
                              merge: bool = True,
                              alpha: float = 16.0,
                              r: int = 8) -> Dict[str, np.ndarray]:
    """Strip peft prefixes from a torch state dict; optionally merge
    `lora_A/lora_B` pairs into the corresponding base weights
    (peft naming: `...q_proj.lora_A.weight` with base
    `...q_proj.base_layer.weight` or `...q_proj.weight`)."""
    out: Dict[str, np.ndarray] = {}
    loras: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        k = k.replace("base_model.model.", "")
        k = k.replace(".base_layer.", ".")
        if ".lora_A." in k or ".lora_B." in k:
            which = "A" if ".lora_A." in k else "B"
            base = k.split(".lora_")[0] + ".weight"
            loras.setdefault(base, {})[which] = np.asarray(v)
            continue
        k = k.replace(".default.", ".")
        out[k] = np.asarray(v)
    if merge:
        for base, ab in loras.items():
            if "A" in ab and "B" in ab and base in out:
                # torch linear: W (out, in); delta = B @ A
                out[base] = out[base] + (ab["B"] @ ab["A"]) * (alpha / r)
    return out
