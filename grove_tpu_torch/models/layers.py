"""Shared building blocks.

Counterpart of `grove_tpu/models/layers.py`: the bf16 inference parts, the
quantized linears `Int8Linear` (W8A16, and W8A8 with dynamic per-token or
static per-tensor activations) and `Int4Linear` (W4A16), and the W8A8
tower parts `LayerNormQuant` and `Int8Conv3d` with the activation
quantizers `quant_act` / `quant_act_static`. Int4Linear's W4A8 mode is
ROADMAP Queue 1 item 11b. Module and parameter names follow the reference
torch checkpoints, so `checkpoint.convert.load_reference_state_dict` loads
them strictly; the quantized modules keep the JAX package's buffer names
and layouts (`kernel_q`, `kernel_q4p`, `scale`, `act_scale`).

Calibration: a W8A8 site that quantizes its own input records the running
absmax of what it quantizes (`record_absmax`) while
`ops.quant.recording_act_stats` is on for its tower, the counterpart of
the flax `sow` into `act_stats` (`layers.py:52-59`).

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

from ..ops.fused_ln import add_layernorm_quant, layernorm_quant
from ..ops.int4_matmul import int4_matmul
from ..ops.int8_matmul import column_major, int8_matmul
from ..ops.quant import (int4_group, quantize_kernel, quantize_kernel_int4,
                         unpack_int4)


def quant_act(x):
    """Dynamic per-token int8: x (..., K) -> (int8, (..., 1) fp32 scale),
    x ~= xq * sx, sx = max(absmax / 127, 1e-12) (`layers.py:26-35`)."""
    xf = x.float()
    sx = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def quant_act_static(x, scale):
    """Static per-tensor int8 with a calibrated fp32 scalar scale: a
    division, round half to even, clamp to +-127 (`layers.py:38-49`)."""
    xq = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return xq.to(torch.int8), scale


def record_absmax(mod: nn.Module, name: str, x) -> None:
    """Keep the running max of |x| under `name` in `mod.act_stats` when a
    calibration pass turned recording on (`ops.quant.recording_act_stats`);
    nothing otherwise."""
    stats = getattr(mod, "act_stats", None)
    if stats is not None:
        v = x.detach().float().abs().amax()
        stats[name] = torch.maximum(stats[name], v) if name in stats else v


def _scalar_buffer(mod: nn.Module, name: str, device) -> None:
    """A calibrated per-tensor fp32 scale: 1 until `calibrate` installs it
    (the JAX init's placeholder)."""
    mod.register_buffer(name, torch.ones((), dtype=torch.float32,
                                         device=device))


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
    """int8-weight linear: y = (x @ kernel_q) * scale [+ bias].

    Counterpart of `Int8Dense` (`layers.py:62-126`): kernel_q (K, N) int8
    and a per-output-channel fp32 scale (N,), the JAX parameter layout, as
    buffers, and an optional float `bias` parameter. Two modes:

    * W8A16 (`act_quant=False`, the LLM): the kernel is cast to the compute
      dtype for a plain matmul, as XLA computes it outside any Pallas
      kernel;
    * W8A8 (`act_quant=True`, the vision towers): the activations are int8,
      either handed in pre-quantized as `(x_int8, sx)` by a producer that
      already quantized them (a `LayerNormQuant`, K1q), or quantized here:
      per token (`quant_act`) or, with `static_act`, per tensor with the
      calibrated `act_scale` buffer (`quant_act_static`). The product is
      exact in int32 (`ops.int8_matmul`) and the epilogue is
      `(acc * sx) * scale + bias` in fp32, cast to the compute dtype.
      A single-token row (x of shape (..., 1, K)) takes the W8A16 path, as
      in the JAX module.

    `act_site` marks a W8A8 linear that quantizes its own input (SAM lin2,
    CLIP out_proj and fc2): it owns `act_scale` and records the absmax of
    its input during calibration. In W8A8 the (K, N) kernel_q is stored
    column-major (`ops.int8_matmul.column_major`): the same values, shape
    and name, in the layout the card's int8 GEMM runs fast. A fresh module
    holds the JAX init's placeholders (zero kernel, unit scales);
    `from_kernel` / `from_linear` quantize float weights."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = False, act_quant: bool = False,
                 act_site: bool = False, static_act: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = dtype or torch.get_default_dtype()
        self.act_quant, self.static_act = act_quant, static_act
        kq = torch.empty((in_features, out_features), dtype=torch.int8,
                         device=device)
        self.register_buffer("kernel_q", column_major(kq) if act_quant
                             else kq)
        self.register_buffer("scale", torch.empty(
            (out_features,), dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)
        if act_site:
            _scalar_buffer(self, "act_scale", device)
        self.reset_placeholders_()

    @torch.no_grad()
    def reset_placeholders_(self):
        if not self.kernel_q.is_meta:
            self.kernel_q.zero_()
            self.scale.fill_(1.0)
            if hasattr(self, "act_scale"):
                self.act_scale.fill_(1.0)

    @classmethod
    def from_kernel(cls, kernel: torch.Tensor, **kw) -> "Int8Linear":
        mod = cls(*kernel.shape, device="meta", dtype=kernel.dtype, **kw)
        kq, mod.scale = quantize_kernel(kernel)
        mod.kernel_q = column_major(kq) if mod.act_quant else kq
        return mod

    @classmethod
    def from_linear(cls, lin: nn.Linear, **kw) -> "Int8Linear":
        """Quantize an `nn.Linear` (its weight transposed to the JAX (K, N)
        layout), keeping its bias."""
        mod = cls.from_kernel(lin.weight.t(), bias=lin.bias is not None, **kw)
        if lin.bias is not None:
            mod.bias = nn.Parameter(lin.bias.detach(), requires_grad=False)
        if hasattr(mod, "act_scale"):
            mod.act_scale = torch.ones((), dtype=torch.float32,
                                       device=lin.weight.device)
        return mod

    def forward(self, x, sx=None):
        dt = self.compute_dtype
        w8a8 = self.act_quant and (x.dim() < 3 or x.shape[-2] > 1)
        if sx is None and not w8a8:
            y = torch.matmul(x.to(dt), self.kernel_q.to(dt)) * self.scale.to(dt)
            return y if self.bias is None else y + self.bias.to(dt)
        if sx is None:
            record_absmax(self, "absmax", x)
            x, sx = (quant_act_static(x, self.act_scale) if self.static_act
                     else quant_act(x))
        lead = x.shape[:-1]
        acc = int8_matmul(x.reshape(-1, self.in_features).contiguous(),
                          self.kernel_q)
        y = acc.float().reshape(*lead, self.out_features) * sx * self.scale
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(dt)

    def extra_repr(self):
        mode = ("W8A8 " + ("static" if self.static_act else "dynamic")
                if self.act_quant else "W8A16")
        return (f"{self.in_features}, {self.out_features}, {mode}, "
                f"bias={self.bias is not None}")


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


class LayerNormQuant(nn.Module):
    """LayerNorm that emits its output int8-quantized for the W8A8 towers:
    x -> (q, scale), or with `branch`: (resid = x + branch, q, scale).

    Counterpart of `LayerNormQuant` (`layers.py:281-340`). It keeps the
    reference `weight` / `bias` names of the `nn.LayerNorm` it replaces and
    owns the site's `act_scale` buffer.

    * static (`static_act`): `ops.fused_ln.add_layernorm_quant` (K8b) with
      a branch, else `ops.fused_ln.layernorm_quant` (K8a when `use_kernel`,
      `cfg.quant_ln_kernel`); the scale is `act_scale`;
    * dynamic (before calibration, and the calibration pass itself): the
      LayerNorm in fp32, then `quant_act` per token; records the absmax of
      the normalized output, which is what static mode scales."""

    def __init__(self, dim: int, eps: float = 1e-6, *,
                 static_act: bool = False, use_kernel: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.eps, self.static_act, self.use_kernel = eps, static_act, use_kernel
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        _scalar_buffer(self, "act_scale", device)

    @torch.no_grad()
    def reset_placeholders_(self):
        if not self.act_scale.is_meta:
            self.act_scale.fill_(1.0)

    @classmethod
    def from_layernorm(cls, ln: nn.LayerNorm, **kw) -> "LayerNormQuant":
        mod = cls(ln.normalized_shape[0], ln.eps, device="meta",
                  dtype=ln.weight.dtype, **kw)
        mod.weight = nn.Parameter(ln.weight.detach(), requires_grad=False)
        mod.bias = nn.Parameter(ln.bias.detach(), requires_grad=False)
        mod.act_scale = torch.ones((), dtype=torch.float32,
                                   device=ln.weight.device)
        return mod

    def forward(self, x, branch=None):
        if self.static_act:
            s = self.act_scale
            if branch is not None:
                resid, q = add_layernorm_quant(x, branch, self.weight,
                                               self.bias, s, eps=self.eps)
                return resid, q, s
            return layernorm_quant(x, self.weight, self.bias, s, eps=self.eps,
                                   use_kernel=self.use_kernel), s
        resid = x if branch is None else x + branch.to(x.dtype)
        xf = resid.float()
        mu = xf.mean(-1, keepdim=True)
        d = xf - mu
        var = (d * d).mean(-1, keepdim=True)
        y = d * torch.rsqrt(var + self.eps) * self.weight.float() \
            + self.bias.float()
        record_absmax(self, "absmax", y)
        out = quant_act(y)
        return out if branch is None else (resid, *out)

    def extra_repr(self):
        return (f"{self.weight.shape[0]}, eps={self.eps}, "
                f"{'static' if self.static_act else 'dynamic'}, "
                f"use_kernel={self.use_kernel}")


class MLPBlock(nn.Module):
    """SAM MLPBlock: Linear -> act -> Linear (`common.py` MLPBlock); with
    `w8a8` both are W8A8 `Int8Linear`s, lin1 fed the int8 output of the
    preceding `LayerNormQuant` and lin2 quantizing its own input
    (`layers.py:403-424`)."""

    def __init__(self, embed_dim: int, mlp_dim: int,
                 act: Callable = gelu_tanh, *, w8a8: bool = False,
                 static_act: bool = False, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.act = act
        if w8a8:
            self.lin1 = Int8Linear(embed_dim, mlp_dim, bias=True,
                                   act_quant=True, static_act=static_act, **f)
            self.lin2 = Int8Linear(mlp_dim, embed_dim, bias=True,
                                   act_quant=True, act_site=True,
                                   static_act=static_act, **f)
        else:
            self.lin1 = nn.Linear(embed_dim, mlp_dim, **f)
            self.lin2 = nn.Linear(mlp_dim, embed_dim, **f)

    def forward(self, x, sx=None):
        if sx is None:
            return self.lin2(self.act(self.lin1(x)))
        return self.lin2(self.act(self.lin1(x, sx)))


class Int8Conv3d(nn.Module):
    """W8A8 form of the adapters' SAME-padded Conv3d, channels-last
    (`_Conv3dShifts._quant_call`, `layers.py:494-535`).

    kernel_q (kt, kh, kw, Cin, Cout) int8 with one fp32 scale per output
    channel over all taps, a float `bias`, and `act_scale`. The activation
    scale is per tensor (its dynamic absmax, or the static `act_scale`), so
    it factors out of the tap sum: 27 exact int8 products in the order dt,
    dh, dw, each cast to the running sum's dtype, which is bf16 when x is
    bf16 (as in the JAX module) and fp32 otherwise; then
    `(sum * sx) * scale + bias` in fp32, cast to x's dtype. Each tap's
    (Cin, Cout) slice is stored column-major, as `Int8Linear` stores its
    kernel."""

    def __init__(self, channels: int, kernel: Tuple[int, int, int], *,
                 static_act: bool = False, device=None, dtype=None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.static_act = static_act
        self.register_buffer("kernel_q", column_major(torch.empty(
            (*self.kernel, channels, channels), dtype=torch.int8,
            device=device)))
        self.register_buffer("scale", torch.empty(
            (channels,), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device,
                                             dtype=dtype))
        _scalar_buffer(self, "act_scale", device)
        self.reset_placeholders_()

    @torch.no_grad()
    def reset_placeholders_(self):
        if not self.kernel_q.is_meta:
            self.kernel_q.zero_()
            self.scale.fill_(1.0)
            self.act_scale.fill_(1.0)

    @classmethod
    def from_conv(cls, conv: nn.Conv3d, **kw) -> "Int8Conv3d":
        """Quantize an `nn.Conv3d`: its (Cout, Cin, kt, kh, kw) weight is
        permuted to the JAX (kt, kh, kw, Cin, Cout) layout first."""
        w = conv.weight
        mod = cls(w.shape[0], tuple(w.shape[2:]), device="meta",
                  dtype=w.dtype, **kw)
        kq, mod.scale = quantize_kernel(w.permute(2, 3, 4, 1, 0))
        mod.kernel_q = column_major(kq)
        mod.bias = nn.Parameter(conv.bias.detach(), requires_grad=False)
        mod.act_scale = torch.ones((), dtype=torch.float32, device=w.device)
        return mod

    def forward(self, x):                               # (b, t, h, w, c)
        kt, kh, kw = self.kernel
        b, t, hh, ww, cin = x.shape
        record_absmax(self, "absmax", x)
        if self.static_act:
            sx = self.act_scale
            xq, _ = quant_act_static(x, sx)
        else:
            xf = x.float()
            sx = (xf.abs().amax() / 127.0).clamp_min(1e-12)
            xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
        xp = F.pad(xq, (0, 0, kw // 2, kw - 1 - kw // 2, kh // 2,
                        kh - 1 - kh // 2, kt // 2, kt - 1 - kt // 2))
        acc_dt = x.dtype if x.dtype == torch.bfloat16 else torch.float32
        cout = self.kernel_q.shape[-1]
        out = torch.zeros((b * t * hh * ww, cout), device=x.device,
                          dtype=acc_dt)
        for dt_ in range(kt):
            for dh in range(kh):
                for dw in range(kw):
                    sl = xp[:, dt_:dt_ + t, dh:dh + hh, dw:dw + ww]
                    tap = int8_matmul(sl.reshape(-1, cin),
                                      self.kernel_q[dt_, dh, dw])
                    out = out + tap.float().to(acc_dt)
        y = (out.float() * sx) * self.scale + self.bias.float()
        return y.to(x.dtype).reshape(b, t, hh, ww, cout)


class SpatioTemporalConvAdapter(nn.Module):
    """Gated 3-D conv video adapter: x + tanh(alpha) * relu(conv3d(x)).

    Input (b, t, h, w, c) channels-last; the SAME-padded Conv3d runs on a
    channels-first view, or with `w8a8` as `Int8Conv3d` on the
    channels-last grid. alpha is zero-initialized in the reference, so the
    adapter starts as the identity."""

    def __init__(self, channels: int,
                 kernel: Tuple[int, int, int] = (3, 3, 3), *,
                 w8a8: bool = False, static_act: bool = False, device=None,
                 dtype=None):
        super().__init__()
        if w8a8:
            self.conv3d = Int8Conv3d(channels, kernel, static_act=static_act,
                                     device=device, dtype=dtype)
        else:
            self.conv3d = nn.Conv3d(channels, channels, kernel,
                                    padding=tuple(k // 2 for k in kernel),
                                    device=device, dtype=dtype)
        self.alpha = nn.Parameter(torch.zeros(1, device=device, dtype=dtype))

    def forward(self, x):                               # (b, t, h, w, c)
        if isinstance(self.conv3d, Int8Conv3d):
            y = self.conv3d(x)
        else:
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
