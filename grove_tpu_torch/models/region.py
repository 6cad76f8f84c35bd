"""Region encoder: parameters only, for the strict checkpoint load.

Counterpart of `grove_tpu/models/region.py` (reference `model/layers.py:
96-341`, MLVLFuseModule + MlvlRoIExtractor + MLVLROIQueryModule). Video
flows never run it, but its weights ship in every checkpoint, so the module
tree is declared here. Its forward, and `ops/roi_align.py` (RoIAlign with
mmcv semantics), are ROADMAP Queue 1 item 7 and raise until then.
"""

from __future__ import annotations

from torch import nn

_NOT_PORTED = ("the region encoder's forward and RoIAlign are not ported "
               "yet (ROADMAP Queue 1 item 7)")


class _FuseConv(nn.Module):
    """mmcv ConvModule: 3x3 conv (no bias) + GroupNorm (+ ReLU)."""

    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1, bias=False, device=device,
                              dtype=dtype)
        self.gn = nn.GroupNorm(min(64, c), c, device=device, dtype=dtype)


class MLVLFuseModule(nn.Module):
    def __init__(self, embed_dims: int, num_levels: int = 4,
                 num_fuse: int = 5, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.input_conv = nn.ModuleList(nn.Conv2d(embed_dims + 2, embed_dims,
                                                  1, **f)
                                        for _ in range(num_levels))
        self.fuse_convs = nn.ModuleList(_FuseConv(embed_dims, **f)
                                        for _ in range(num_fuse))

    def forward(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)


class MlvlRoIExtractor(nn.Module):
    def __init__(self, embed_dims: int, out_dims: int, num_levels: int = 4,
                 output_size: int = 14, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.pconvs = nn.ModuleList(nn.Conv2d(embed_dims, embed_dims, 3,
                                              padding=1, **f)
                                    for _ in range(num_levels))
        self.pos_embedd = nn.Sequential(
            nn.Linear(4, 256, **f), nn.ReLU(), nn.LayerNorm(256, **f),
            nn.Linear(256, 1024, **f), nn.ReLU(), nn.LayerNorm(1024, **f))
        self.flatten_linear = nn.Linear(embed_dims * output_size ** 2, 1024,
                                        **f)
        self.updims = nn.Linear(1024, out_dims, **f)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)


class MLVLROIQueryModule(nn.Module):
    def __init__(self, embed_dims: int, out_dims: int, num_levels: int = 4,
                 *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.mlvl_fuse = MLVLFuseModule(embed_dims, num_levels, **f)
        self.roi_align = MlvlRoIExtractor(embed_dims, out_dims, num_levels,
                                          **f)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)
