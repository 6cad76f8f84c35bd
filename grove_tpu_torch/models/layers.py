"""Shared building blocks.

Counterpart of `grove_tpu/models/layers.py`: the bf16 inference parts and
the weight-only quantized linears `Int8Linear` (W8A16) and `Int4Linear`
(W4A16). Their activation-quantized modes and `LayerNormQuant` are ROADMAP
Queue 1 items 11b and 11c. Module and parameter names follow the reference
torch checkpoints, so `checkpoint.convert.load_reference_state_dict` loads
them strictly; the quantized linears keep the JAX package's buffer names
and layouts (`kernel_q`, `kernel_q4p`, `scale`).

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

from ..ops.int4_matmul import int4_matmul
from ..ops.quant import (int4_group, quantize_kernel, quantize_kernel_int4,
                         unpack_int4)


def check_vision_config(cfg) -> None:
    """The port runs the bf16 vision towers only."""
    if cfg.quant_w8a8:
        raise NotImplementedError(
            f"{type(cfg).__name__}.quant_w8a8: the W8A8 vision path is not "
            "ported yet (ROADMAP Queue 1 item 11c, W8A8-static towers)")


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


class Int8Linear(nn.Module):
    """int8-weight linear, W8A16: y = (x @ kernel_q) * scale, no bias.

    Counterpart of `Int8Dense` (`layers.py:62-126`) with `act_quant=False`:
    kernel_q (K, N) int8 and a per-output-channel fp32 scale (N,), the
    JAX parameter layout, as buffers. The kernel is cast to the compute
    dtype for a plain matmul, as XLA computes it outside any Pallas
    kernel. A fresh module holds the JAX init's placeholders (zeros,
    ones); `from_kernel` quantizes a float (K, N) kernel."""

    def __init__(self, in_features: int, out_features: int, *, device=None,
                 dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = dtype or torch.get_default_dtype()
        self.register_buffer("kernel_q", torch.empty(
            (in_features, out_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty(
            (out_features,), dtype=torch.float32, device=device))
        self.reset_placeholders_()

    @torch.no_grad()
    def reset_placeholders_(self):
        if not self.kernel_q.is_meta:
            self.kernel_q.zero_()
            self.scale.fill_(1.0)

    @classmethod
    def from_kernel(cls, kernel: torch.Tensor) -> "Int8Linear":
        mod = cls(*kernel.shape, device="meta", dtype=kernel.dtype)
        mod.kernel_q, mod.scale = quantize_kernel(kernel)
        return mod

    def forward(self, x):
        dt = self.compute_dtype
        y = torch.matmul(x.to(dt), self.kernel_q.to(dt))
        return y * self.scale.to(dt)

    def extra_repr(self):
        return f"{self.in_features}, {self.out_features}, W8A16"


class Int4Linear(nn.Module):
    """int4-weight linear, W4A16, group-wise scales, no bias.

    Counterpart of `Int4Dense` (`layers.py:129-278`) with `act_quant=False`:
    kernel_q4p (K/2, N) int8, group-pair packed (`ops.quant.pack_int4`),
    and scale (K/G, N) fp32, as buffers; G is `group` halved until 2G
    divides K (narrow test configs). Dispatch, as the JAX package's:
    * CUDA, fewer than 64 rows (decode): K7a, `ops.int4_matmul`;
    * CUDA, 64 rows or more (prefill, teacher-forced pass): a dequantized
      view in the compute dtype and `torch.matmul` (`layers.py:238-256`
      takes a plain XLA dot there);
    * CPU: K7a's plain twin, the JAX package's grouped einsum."""

    def __init__(self, in_features: int, out_features: int,
                 group: int = 128, *, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = dtype or torch.get_default_dtype()
        g = int4_group(in_features, group)
        self.register_buffer("kernel_q4p", torch.empty(
            (in_features // 2, out_features), dtype=torch.int8,
            device=device))
        self.register_buffer("scale", torch.empty(
            (in_features // g, out_features), dtype=torch.float32,
            device=device))
        self.reset_placeholders_()

    @torch.no_grad()
    def reset_placeholders_(self):
        if not self.kernel_q4p.is_meta:
            self.kernel_q4p.zero_()
            self.scale.fill_(1.0)

    @classmethod
    def from_kernel(cls, kernel: torch.Tensor,
                    group: int = 128) -> "Int4Linear":
        mod = cls(*kernel.shape, group, device="meta", dtype=kernel.dtype)
        mod.kernel_q4p, mod.scale = quantize_kernel_int4(kernel, group)
        return mod

    @property
    def group(self) -> int:
        return self.in_features // self.scale.shape[0]

    def dequantized(self) -> torch.Tensor:
        """(K, N) weights in the compute dtype."""
        w = unpack_int4(self.kernel_q4p, self.group).float()
        return (w * self.scale[:, None, :]).to(self.compute_dtype).reshape(
            self.in_features, self.out_features)

    def forward(self, x):
        lead = x.shape[:-1]
        x2 = x.to(self.compute_dtype).reshape(-1, self.in_features)
        if x2.is_cuda and x2.shape[0] >= 64:
            y = torch.matmul(x2, self.dequantized())
        else:
            y = int4_matmul(x2, self.kernel_q4p, self.scale)
        return y.reshape(*lead, self.out_features)

    def extra_repr(self):
        return (f"{self.in_features}, {self.out_features}, W4A16, "
                f"group={self.group}")


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
