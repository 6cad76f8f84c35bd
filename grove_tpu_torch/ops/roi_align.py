"""RoIAlign with mmcv semantics (counterpart of `grove_tpu/ops/roi_align.py`).

Replaces the mmcv CUDA RoIAlign of the reference region encoder
(`model/layers.py:209-217`: output 14x14, sampling ratio 2). For every RoI
and output cell, `sampling_ratio`^2 points are sampled bilinearly and
averaged. Out-of-bounds samples follow mmcv: a point outside [-1, size]
contributes zero, a point inside that band is clamped to the edge;
`aligned=False` gives each RoI a size of at least 1.

The JAX function gathers from `features[batch_idx]`, a copy of the whole
map per RoI. Here the four corners of every sample are gathered from the
flattened (B*H*W, C) map, the RoI's batch offset folded into the row
index, so a call reads only the rows its samples touch. The corners are
gathered in the map's dtype and cast to fp32, which equals casting the map
first. Plain torch ops (the JAX function is plain XLA, not a Pallas
kernel).
"""

from __future__ import annotations

import torch


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """features (B, H, W, C); rois (N, 5) [batch_idx, x1, y1, x2, y2] in
    input-image coordinates. Returns (N, output_size, output_size, C)
    fp32."""
    b, h, w, c = features.shape
    dev = features.device
    rois = torch.as_tensor(rois, device=dev).float()
    offset = 0.5 if aligned else 0.0
    batch_idx = rois[:, 0].long()
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp_min(1.0), roi_h.clamp_min(1.0)
    bin_w, bin_h = roi_w / output_size, roi_h / output_size

    r = sampling_ratio
    cell = torch.arange(output_size, dtype=torch.float32, device=dev)
    sub = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) / r
    frac = cell[:, None] + sub[None, :]                   # (out, r)
    ys = y1[:, None, None] + frac[None] * bin_h[:, None, None]
    xs = x1[:, None, None] + frac[None] * bin_w[:, None, None]
    yy = ys[:, :, :, None, None]                          # (N, oy, ry, 1, 1)
    xx = xs[:, None, None, :, :]                          # (N, 1, 1, ox, rx)
    valid = (yy >= -1.0) & (yy <= h) & (xx >= -1.0) & (xx <= w)
    ycl, xcl = yy.clamp(0.0, h - 1), xx.clamp(0.0, w - 1)
    y0, x0 = torch.floor(ycl).long(), torch.floor(xcl).long()
    y1i, x1i = (y0 + 1).clamp_max(h - 1), (x0 + 1).clamp_max(w - 1)
    ly, lx = ycl - y0, xcl - x0
    hy, hx = 1.0 - ly, 1.0 - lx

    flat = features.reshape(b * h * w, c)
    base = (batch_idx * (h * w))[:, None, None, None, None]
    shape = torch.broadcast_shapes(y0.shape, x0.shape)

    def corner(yi, xi):
        idx = (base + yi * w + xi).expand(shape).reshape(-1)
        return flat.index_select(0, idx).float().reshape(shape + (c,))

    val = (corner(y0, x0) * (hy * hx)[..., None]
           + corner(y0, x1i) * (hy * lx)[..., None]
           + corner(y1i, x0) * (ly * hx)[..., None]
           + corner(y1i, x1i) * (ly * lx)[..., None])
    val = torch.where(valid[..., None], val, torch.zeros((), device=dev))
    return val.mean(dim=(2, 4))                           # the r^2 samples
