"""Video-token pooling (counterpart of `grove_tpu/ops/pooling.py`).

GROVE uses `spatiotemporal_pool` (AdaptiveAvgPool3d -> 576 tokens). Input
(B, T, H, W, C) patch grids; output (B, N, C) token sequences.
"""

from __future__ import annotations

from typing import Tuple

from ..models.layers import adaptive_avg_pool_3d


def spatiotemporal_pool(x, out_thw: Tuple[int, int, int] = (8, 8, 9)):
    """AdaptiveAvgPool3d over (t, h, w) -> (B, t'*h'*w', C)."""
    b = x.shape[0]
    pooled = adaptive_avg_pool_3d(x, out_thw, axes=(1, 2, 3))
    t, h, w = out_thw
    return pooled.reshape(b, t * h * w, x.shape[-1])
