"""Static rel-pos gather tables for ViTDet attention (q_size == k_size).

Counterpart of `grove_tpu/ops/sam_encoder_tables.py`; mirrors
`image_encoder.py:get_rel_pos:387-417`. The indices are numpy, computed per
call from static sizes.
"""

from __future__ import annotations

import numpy as np
import torch


def rel_pos_index(q_size: int, k_size: int) -> np.ndarray:
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel.astype(np.int64)


def gather_rel_tables(rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                      h: int, w: int):
    """(L, D) tables -> Rh (h, h, D), Rw (w, w, D)."""
    ih = torch.from_numpy(rel_pos_index(h, h)).to(rel_pos_h.device)
    iw = torch.from_numpy(rel_pos_index(w, w)).to(rel_pos_w.device)
    return rel_pos_h[ih], rel_pos_w[iw]
