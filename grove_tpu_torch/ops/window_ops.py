"""ViTDet window partition / unpartition as one row stream each: K14.

Counterpart of `grove_tpu/ops/window_ops.py`. The TPU kernels relayout
between an already padded (B, Hp, Wp, C) grid and the (B*nW, win, win, C)
windows and leave the zero pad and the pad drop to XLA. Here the kernel
(`csrc/window_partition.cu`) takes the unpadded (B, H, W, C) grid on CUDA
tensors and does both itself: the partition writes the pad's zeros, the
unpartition reads only the valid pixels and writes a contiguous (B, H, W, C).
CPU tensors take the plain twins (torch's pad, a `view` / `permute` copy,
a slice), which give the same values. Any dtype moves (the JAX tests run
int8).

One window row, win * C elements, is contiguous on both sides, so each
direction is a stream of rows (`window_copy_plan`): the partition moves
every window row (a row in the pad is all zeros, a row at the right edge
is its valid prefix and a zero tail), the unpartition every valid prefix.

Both directions are linear maps and each other's adjoint, so each is the
other's backward, as the JAX custom VJPs are (pad zeros <-> drop pads).
Semantics match `models.sam_encoder.window_partition` / `window_unpartition`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels

# The launch (`csrc/window_partition.cu`, whose `plan` computes the same).
# The bulk body: persistent CTAs, at most WINDOW_PER_SM an SM, one thread of
# each moving its rows by TMA bulk copies through a ring of up to
# WINDOW_MAX_SLOTS row slots, the partition's zeros stored from one slot of
# WINDOW_ZERO_BYTES zeroed once. It needs C * itemsize % 16 == 0, 16-byte
# aligned bases and room for 2 slots; the vector body (one block a row,
# 16- to 1-byte accesses) takes every other shape.
WINDOW_MAX_SLOTS = 3
WINDOW_PER_SM = 2
WINDOW_ZERO_BYTES = 4096
_SMEM_BLOCK = 232448    # dynamic shared bytes one block can use on sm_90
_SMEM_SM = 233472       # shared bytes an SM holds
_SMEM_RESERVED = 1024   # the runtime's share a block
BODIES = ("vector", "bulk")   # by the C entries' codes for them


class WindowPlan(NamedTuple):
    """One launch of K14. Row t moves `valid[t]` bytes from byte `src[t]`
    of the input to byte `dst[t]` of the output, then writes `zero[t]`
    zero bytes after them; CTA `cta[t]` moves it (the bulk body: CTA k
    walks rows k, k + ctas, ...; the vector body: one block a row)."""
    body: str           # "bulk" or "vector"
    slots: int          # row slots of the bulk body's ring (0: vector)
    smem: int           # dynamic shared bytes a CTA (0: vector)
    per_sm: int         # CTAs an SM (0: vector)
    ctas: int
    src: np.ndarray     # (rows,) int64 byte offsets
    dst: np.ndarray
    valid: np.ndarray   # bytes copied
    zero: np.ndarray    # zero bytes written after them
    cta: np.ndarray

    @property
    def rows(self) -> int:
        return len(self.src)


def _grid(h: int, w: int, win: int) -> Tuple[int, int]:
    return -(-h // win), -(-w // win)


def window_copy_plan(b: int, h: int, w: int, c: int, win: int,
                     itemsize: int, sms: int,
                     unpartition: bool) -> WindowPlan:
    """K14's rows and launch for the unpadded (B, H, W, C) grid of
    `itemsize`-byte elements in windows of `win`, on a card of `sms` SMs,
    as the C entry makes it with 16-byte-aligned bases
    (`grove_window_copy_plan` and `grove_window_copy_rows` report the
    library's). The partition's rows are the window rows in order, row
    t = ((b * gh + i) * gw + j) * win + r: grid row y = i * win + r, its
    valid prefix min(win, W - j * win) pixels where y < H, none where y is
    in the pad. The unpartition's rows are the valid prefixes in the output's
    order, t = (b * H + y) * gw + j, read from window row
    ((b * gh + y // win) * gw + j) * win + y % win."""
    if min(b, h, w, c, win, itemsize, sms) <= 0:
        raise ValueError(f"window_copy_plan: ({b}, {h}, {w}, {c}), win "
                         f"{win}, itemsize {itemsize}, {sms} SMs")
    gh, gw = _grid(h, w, win)
    pixel = c * itemsize
    row = win * pixel
    if unpartition:
        t = np.arange(b * h * gw, dtype=np.int64)
        j, y, bb = t % gw, t // gw % h, t // (gw * h)
        src = (((bb * gh + y // win) * gw + j) * win + y % win) * row
        dst = ((bb * h + y) * w + j * win) * pixel
        valid = np.minimum(win, w - j * win) * pixel
        zero = np.zeros_like(t)
    else:
        t = np.arange(b * gh * gw * win, dtype=np.int64)
        r, j, i, bb = (t % win, t // win % gw, t // (win * gw) % gh,
                       t // (win * gw * gh))
        y = i * win + r
        inside = y < h
        valid = np.where(inside, np.minimum(win, w - j * win) * pixel, 0)
        src = np.where(inside, ((bb * h + y) * w + j * win) * pixel, 0)
        dst = t * row
        zero = row - valid
    zero_slot = 0 if unpartition else WINDOW_ZERO_BYTES
    slots = min(WINDOW_MAX_SLOTS,
                (_SMEM_BLOCK - zero_slot - 8 * WINDOW_MAX_SLOTS) // row)
    if pixel % 16 or slots < 2:
        return WindowPlan("vector", 0, 0, 0, len(t), src, dst, valid, zero,
                          t.copy())
    smem = slots * row + zero_slot + 8 * slots
    per_sm = min(WINDOW_PER_SM, _SMEM_SM // (smem + _SMEM_RESERVED))
    ctas = min(len(t), per_sm * sms)
    return WindowPlan("bulk", slots, smem, per_sm, ctas, src, dst, valid,
                      zero, t % ctas)


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


def _copy(kernel: str, src, out, b: int, h: int, w: int, win: int):
    """Launch `kernel` on the unpadded (B, H, W) grid: it pads or drops the
    pad itself."""
    if not src.is_contiguous():
        raise ValueError(f"{kernel}: inputs must be contiguous")
    with torch.cuda.device(src.device):
        _kernels.KERNELS[kernel](src.data_ptr(), out.data_ptr(), b, h, w,
                                 src.shape[-1], win, src.element_size(),
                                 _kernels.stream_ptr(src))
    return out


def _partition(x, win: int):
    """Zero pad to multiples of win and partition: torch's pad and copy on
    the CPU, one kernel on CUDA."""
    b, h, w, c = x.shape
    gh, gw = _grid(h, w, win)
    if _kernels.on_cpu(x):
        x = F.pad(x, (0, 0, 0, gw * win - w, 0, gh * win - h))
        return window_partition_torch(x, win)
    out = torch.empty((b * gh * gw, win, win, c), device=x.device,
                      dtype=x.dtype)
    return _copy("window_partition", x, out, b, h, w, win)


def _unpartition(windows, win: int, hw: Tuple[int, int]):
    """Unpartition and drop the pads: torch's copy and a slice on the CPU,
    one kernel writing a contiguous (B, H, W, C) on CUDA."""
    h, w = hw
    gh, gw = _grid(h, w, win)
    nw = gh * gw
    if windows.shape[0] % nw or tuple(windows.shape[1:3]) != (win, win):
        raise ValueError(f"window_unpartition_fused: windows "
                         f"{tuple(windows.shape)} do not tile {hw} in "
                         f"windows of {win}")
    b, c = windows.shape[0] // nw, windows.shape[-1]
    if _kernels.on_cpu(windows):
        out = window_unpartition_torch(windows, win, b, gh * win, gw * win)
        return out[:, :h, :w]
    out = torch.empty((b, h, w, c), device=windows.device,
                      dtype=windows.dtype)
    return _copy("window_unpartition", windows, out, b, h, w, win)


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
