"""ViTDet window partition / unpartition as one block copy each: K14.

Counterpart of `grove_tpu/ops/window_ops.py`. The zero pad before the
partition and the pad drop after the unpartition stay in torch (`F.pad`, a
slice), as they stay in XLA there; the relayout between the (B, Hp, Wp, C)
grid and the (B*nW, win, win, C) windows is the kernel
(`csrc/window_partition.cu`) on CUDA tensors and its plain twin (a
`view` / `permute` copy) on CPU tensors. Any dtype moves (the JAX tests run
int8).

Both directions are linear maps and each other's adjoint, so each is the
other's backward, as the JAX custom VJPs are (pad zeros <-> drop pads).
Semantics match `models.sam_encoder.window_partition` / `window_unpartition`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .. import _kernels


def window_partition_torch(x, win: int):
    """Plain version of the partition copy: x (B, Hp, Wp, C) with Hp and Wp
    multiples of win -> (B*nW, win, win, C)."""
    b, hp, wp, c = x.shape
    y = x.reshape(b, hp // win, win, wp // win, win, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)


def window_unpartition_torch(windows, win: int, b: int, hp: int, wp: int):
    """Plain version of the unpartition copy -> (B, Hp, Wp, C)."""
    c = windows.shape[-1]
    y = windows.reshape(b, hp // win, wp // win, win, win, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)


def _copy(kernel: str, src, out, b: int, hp: int, wp: int, win: int):
    if not src.is_contiguous():
        raise ValueError(f"{kernel}: inputs must be contiguous")
    with torch.cuda.device(src.device):
        _kernels.KERNELS[kernel](src.data_ptr(), out.data_ptr(), b, hp, wp,
                                 src.shape[-1], win, src.element_size(),
                                 _kernels.stream_ptr(src))
    return out


def _partition(x, win: int):
    """Zero pad to multiples of win, then the partition copy."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % win, (-w) % win
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    if _kernels.on_cpu(x):
        return window_partition_torch(x, win)
    out = torch.empty((b * (hp // win) * (wp // win), win, win, c),
                      device=x.device, dtype=x.dtype)
    return _copy("window_partition", x, out, b, hp, wp, win)


def _unpartition(windows, win: int, hw: Tuple[int, int]):
    """The unpartition copy, then the pads dropped."""
    h, w = hw
    gh, gw = -(-h // win), -(-w // win)
    hp, wp = gh * win, gw * win
    nw = gh * gw
    if windows.shape[0] % nw or tuple(windows.shape[1:3]) != (win, win):
        raise ValueError(f"window_unpartition_fused: windows "
                         f"{tuple(windows.shape)} do not tile {hw} in "
                         f"windows of {win}")
    b, c = windows.shape[0] // nw, windows.shape[-1]
    if _kernels.on_cpu(windows):
        out = window_unpartition_torch(windows, win, b, hp, wp)
    else:
        out = _copy("window_unpartition", windows,
                    torch.empty((b, hp, wp, c), device=windows.device,
                                dtype=windows.dtype), b, hp, wp, win)
    if hp != h or wp != w:
        out = out[:, :h, :w]
    return out


class _Partition(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, win):
        ctx.win, ctx.hw = win, tuple(x.shape[1:3])
        return _partition(x, win)

    @staticmethod
    def backward(ctx, g):
        return _unpartition(g.contiguous(), ctx.win, ctx.hw), None


class _Unpartition(torch.autograd.Function):
    @staticmethod
    def forward(ctx, windows, win, hw):
        ctx.win = win
        return _unpartition(windows, win, hw)

    @staticmethod
    def backward(ctx, g):
        return _partition(g.contiguous(), ctx.win), None, None


def window_partition_fused(x, win: int):
    """(B, H, W, C) -> (B*nW, win, win, C), zero-padded, one copy;
    differentiable (the backward is the unpartition)."""
    return _Partition.apply(x, win)


def window_unpartition_fused(windows, win: int, hw: Tuple[int, int]):
    """(B*nW, win, win, C) -> (B, H, W, C), pads dropped, one copy;
    differentiable (the backward is the partition)."""
    return _Unpartition.apply(windows, win, tuple(hw))
