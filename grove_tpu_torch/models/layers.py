"""Shared building blocks, bf16 inference parts.

Counterpart of `grove_tpu/models/layers.py` without the quantized layers
(`Int8Dense`, `Int4Dense`, `LayerNormQuant`: ROADMAP Queue 1 item 11).
Module and parameter names follow the reference torch checkpoints, so
`checkpoint.convert.load_reference_state_dict` loads them strictly.

Layouts: the video adapter and pooling keep the JAX package's channels-last
token grids; `LayerNorm2d` normalizes dim 1 of NCHW maps like the reference
torch module, because it sits between torch convolutions.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def check_vision_config(cfg) -> None:
    """The port runs the bf16 vision towers only."""
    if cfg.quant_w8a8:
        raise NotImplementedError(
            f"{type(cfg).__name__}.quant_w8a8: the W8A8 vision path is not "
            "ported yet (ROADMAP Queue 1 item 11, quantized serving)")


def gelu_tanh(x):
    """flax `nn.gelu` default (tanh approximation), used by the JAX SAM
    MLPBlock."""
    return F.gelu(x, approximate="tanh")


class RMSNorm(nn.Module):
    """LLaMA RMSNorm; statistics in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x):
        xf = x.float()
        var = xf.pow(2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + self.eps)
        return (out * self.weight.float()).to(x.dtype)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NCHW maps (reference `common.py` LayerNorm2d).
    Statistics in fp32; output in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device,
                                             dtype=dtype))

    def forward(self, x):                               # (N, C, H, W)
        xf = x.float()
        mu = xf.mean(1, keepdim=True)
        var = (xf - mu).pow(2).mean(1, keepdim=True)
        out = (xf - mu) / torch.sqrt(var + self.eps)
        out = (out * self.weight.float()[:, None, None]
               + self.bias.float()[:, None, None])
        return out.to(x.dtype)


class MLP(nn.Module):
    """relu-MLP stack (SAM `mask_decoder.py:232-254` MLP)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, *, device=None, dtype=None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=device, dtype=dtype)
            for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MLPBlock(nn.Module):
    """SAM MLPBlock: Linear -> act -> Linear (`common.py` MLPBlock)."""

    def __init__(self, embed_dim: int, mlp_dim: int,
                 act: Callable = gelu_tanh, *, device=None, dtype=None):
        super().__init__()
        self.act = act
        self.lin1 = nn.Linear(embed_dim, mlp_dim, device=device, dtype=dtype)
        self.lin2 = nn.Linear(mlp_dim, embed_dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class SpatioTemporalConvAdapter(nn.Module):
    """Gated 3-D conv video adapter: x + tanh(alpha) * relu(conv3d(x)).

    Input (b, t, h, w, c) channels-last; the SAME-padded Conv3d runs on a
    channels-first view. alpha is zero-initialized in the reference, so the
    adapter starts as the identity."""

    def __init__(self, channels: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3), *, device=None,
                 dtype=None):
        super().__init__()
        self.conv3d = nn.Conv3d(channels, channels, kernel,
                                padding=tuple(k // 2 for k in kernel),
                                device=device, dtype=dtype)
        self.alpha = nn.Parameter(torch.zeros(1, device=device, dtype=dtype))

    def forward(self, x):                               # (b, t, h, w, c)
        y = self.conv3d(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        y = F.relu(y)
        return torch.tanh(self.alpha).to(x.dtype) * y + x


def _pool_matrix(length: int, out_size: int) -> np.ndarray:
    """(out, L) averaging weights with torch AdaptiveAvgPool bins:
    bin i averages [floor(i*L/out), ceil((i+1)*L/out))."""
    starts = (np.arange(out_size) * length) // out_size
    ends = -(-((np.arange(out_size) + 1) * length) // out_size)
    w = np.zeros((out_size, length), np.float32)
    for i, (s, e) in enumerate(zip(starts, ends)):
        w[i, s:e] = 1.0 / (e - s)
    return w


def adaptive_avg_pool_1d(x: torch.Tensor, out_size: int,
                         axis: int) -> torch.Tensor:
    """AdaptiveAvgPool along one axis, as an (out, L) averaging matmul in
    the input dtype (the JAX package's formulation)."""
    w = torch.from_numpy(_pool_matrix(x.shape[axis], out_size)).to(
        device=x.device, dtype=x.dtype)
    out = torch.matmul(x.movedim(axis, -1), w.t())
    return out.movedim(-1, axis)


def adaptive_avg_pool_3d(x: torch.Tensor, out_thw: Tuple[int, int, int],
                         axes: Tuple[int, int, int] = (1, 2, 3)):
    """AdaptiveAvgPool3d((t, h, w)) over the given axes of x."""
    for size, axis in zip(out_thw, axes):
        x = adaptive_avg_pool_1d(x, size, axis)
    return x
