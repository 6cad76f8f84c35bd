"""Region encoder: multi-level RoI queries for `<bbox>` prompting.

Counterpart of `grove_tpu/models/region.py` (reference `model/layers.py:
96-341`, MLVLFuseModule + MlvlRoIExtractor + MLVLROIQueryModule): the CLIP
levels are upsampled into a pyramid (the largest grid on the shallowest
level), coord-conv'ed, fused by five rounds of channel-shuffled 3x3
conv + GroupNorm + ReLU, RoI-aligned at 14x14 per level (`ops.roi_align`),
summed, flattened to a 1024-d query plus an MLP embedding of the box, and
projected to the LM width.

Maps run NCHW through the convolutions (torch's layout); the RoI features
are flattened in the JAX package's (h, w, c) order (`region.py:141`),
which `flatten_linear` carries over from a JAX tree. Whether the
reference's `model/layers.py` flattens so is open (ROADMAP Queue 3).
GroupNorm and LayerNorm use eps = 1e-6, the flax default the JAX package
runs with.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import roi_align

_EPS = 1e-6


def _bilinear_resize(x, size):
    """NCHW bilinear resize with align_corners=True (`region.py:25-44`,
    torch's F.interpolate semantics, which the JAX function mirrors)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


class _FuseConv(nn.Module):
    """mmcv ConvModule: 3x3 conv (no bias) + GroupNorm (+ ReLU)."""

    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1, bias=False, device=device,
                              dtype=dtype)
        self.gn = nn.GroupNorm(min(64, c), c, eps=_EPS, device=device,
                               dtype=dtype)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class MLVLFuseModule(nn.Module):
    """Coord-conv + channel-shuffled cross-level fusion (`region.py:47-94`):
    each level keeps its first `C - 2 (C // 4)` channels and takes the
    upper level's last quarter and the lower level's second quarter,
    resized to its grid; the five rounds' conv and GroupNorm are shared by
    the levels."""

    def __init__(self, embed_dims: int, num_levels: int = 4,
                 num_fuse: int = 5, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.input_conv = nn.ModuleList(nn.Conv2d(embed_dims + 2, embed_dims,
                                                  1, **f)
                                        for _ in range(num_levels))
        self.fuse_convs = nn.ModuleList(_FuseConv(embed_dims, **f)
                                        for _ in range(num_fuse))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """feats: (B, C, H_l, W_l) per level -> the same shapes, fused."""
        withcoord = []
        for x in feats:
            b, _, h, w = x.shape
            f32 = dict(device=x.device, dtype=torch.float32)
            yy, xx = torch.meshgrid(torch.linspace(-1, 1, h, **f32),
                                    torch.linspace(-1, 1, w, **f32),
                                    indexing="ij")
            coord = torch.stack([xx, yy])[None].expand(b, 2, h, w)
            withcoord.append(torch.cat([x, coord.to(x.dtype)], dim=1))
        feats = [conv(x) for conv, x in zip(self.input_conv, withcoord)]
        c = feats[0].shape[1]
        shuffle = c // 4
        remain = c - 2 * shuffle
        nl = len(feats)
        for fuse in self.fuse_convs:
            fused = []
            for lvl, x in enumerate(feats):
                top = feats[min(lvl + 1, nl - 1)][:, remain + shuffle:]
                down = feats[max(lvl - 1, 0)][:, remain:remain + shuffle]
                size = x.shape[-2:]
                fused.append(torch.cat([x[:, :remain],
                                        _bilinear_resize(top, size),
                                        _bilinear_resize(down, size)], dim=1))
            feats = [fuse(x) for x in fused]
        return feats


class MlvlRoIExtractor(nn.Module):
    """Per-level 14x14 RoIAlign + convs + query projection
    (`region.py:97-144`)."""

    def __init__(self, embed_dims: int, out_dims: int, num_levels: int = 4,
                 output_size: int = 14, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.output_size = output_size
        self.pconvs = nn.ModuleList(nn.Conv2d(embed_dims, embed_dims, 3,
                                              padding=1, **f)
                                    for _ in range(num_levels))
        self.pos_embedd = nn.Sequential(
            nn.Linear(4, 256, **f), nn.ReLU(),
            nn.LayerNorm(256, eps=_EPS, **f), nn.Linear(256, 1024, **f),
            nn.ReLU(),
            nn.LayerNorm(1024, eps=_EPS, **f))
        self.flatten_linear = nn.Linear(embed_dims * output_size ** 2, 1024,
                                        **f)
        self.updims = nn.Linear(1024, out_dims, **f)

    def forward(self, feats: Sequence[torch.Tensor], rois_norm,
                roi_batch_idx) -> torch.Tensor:
        """feats: (B, C, H_l, W_l) per level; rois_norm (N, 4) normalized
        xyxy; roi_batch_idx (N,). Returns (N, out_dims) queries."""
        dt = self.updims.weight.dtype
        dev = self.updims.weight.device
        rois_norm = torch.as_tensor(rois_norm, device=dev)
        idx = torch.as_tensor(roi_batch_idx, device=dev)
        nl = len(feats)
        # the reference scales the normalized RoIs by 224 for the align
        # only, at strides 14/8, 14/4, 14/2, 14 (`layers.py:211,299`); the
        # positional MLP takes them normalized (`layers.py:295-299`)
        rois5 = torch.cat([idx[:, None].float(),
                           rois_norm.float() * 224.0], dim=1)
        pos = self.pos_embedd(rois_norm.to(dt))
        fused = 0.0
        for lvl, (x, pconv) in enumerate(zip(feats, self.pconvs)):
            stride = 14 / 2 ** (nl - 1 - lvl)
            # sampling ratio 2, the reference's (`layers.py:209-217`)
            rf = roi_align(x.permute(0, 2, 3, 1), rois5, self.output_size,
                           1.0 / stride, 2)
            fused = fused + pconv(rf.to(dt).permute(0, 3, 1, 2))
        fused = F.relu(fused)
        flat = fused.permute(0, 2, 3, 1).reshape(fused.shape[0], -1)
        return self.updims(self.flatten_linear(flat) + pos)


class MLVLROIQueryModule(nn.Module):
    """Pyramid upsample -> fuse -> RoI extract (`region.py:147-176`)."""

    def __init__(self, embed_dims: int, out_dims: int, num_levels: int = 4,
                 *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.mlvl_fuse = MLVLFuseModule(embed_dims, num_levels, **f)
        self.roi_align = MlvlRoIExtractor(embed_dims, out_dims, num_levels,
                                          **f)

    def forward(self, mlvl_feats: Sequence[torch.Tensor], rois_norm,
                roi_batch_idx) -> torch.Tensor:
        """mlvl_feats: (B, P, C) patch tokens per level, shallow to deep;
        rois_norm (N, 4) normalized xyxy; roi_batch_idx (N,) into B.
        Returns (N, out_dims) region queries."""
        dt = self.roi_align.updims.weight.dtype
        grids = []
        for x in mlvl_feats:
            b, p, c = x.shape
            g = math.isqrt(p)
            grids.append(x.reshape(b, g, g, c).permute(0, 3, 1, 2))
        bh, bw = grids[0].shape[-2:]
        nl = len(grids)
        sizes = [(bh * 2 ** lvl, bw * 2 ** lvl) for lvl in range(nl)][::-1]
        feats = [_bilinear_resize(x.float(), s).to(dt)
                 for x, s in zip(grids, sizes)]
        return self.roi_align(self.mlvl_fuse(feats), rois_norm,
                              roi_batch_idx)
