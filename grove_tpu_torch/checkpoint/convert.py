"""Load a reference-named state dict into `models.grove.GroveModel`.

The port's module tree carries the reference torch names
(`model.vision_tower.vision_tower.vision_model.*`, `model.layers.N.*`,
`model.grounding_encoder.*`, `lm_head.weight`, ...), so a state dict in that
namespace loads with `strict=True` and no key mapping: the dict that
`grove_tpu/checkpoint/torch_convert.py:to_torch_state_dict` exports from a
JAX parameter tree, or a reference checkpoint.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def load_reference_state_dict(model: nn.Module,
                              sd: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy `sd` (reference torch names -> numpy arrays or tensors) into
    `model`, strictly: a missing key, an unexpected key or a shape mismatch
    raises. Values are cast to each parameter's dtype and device by the
    copy."""
    tensors: Dict[str, torch.Tensor] = {
        k: (v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v)))
        for k, v in sd.items()}
    model.load_state_dict(tensors, strict=True)
    return model
