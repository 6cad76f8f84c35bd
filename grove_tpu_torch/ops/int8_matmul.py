"""The int8 x int8 product of the W8A8 towers, with int32 accumulation.

The JAX package computes it in XLA, outside any Pallas kernel
(`grove_tpu/models/layers.py:113-116`, `:529-533`: `dot_general` with
`preferred_element_type=float32`), so there is no TPU kernel to port here.
On the card it is `torch._int_mm` (int32 accumulation on the int8 tensor
cores); it refuses M <= 16 and K or N not a multiple of 8, and this wrapper
raises for those shapes instead of falling back. Its speed depends on the
layout of b: column-major (the bytes of the (N, K) transpose, as the W8A8
modules store their weights) runs on the tensor cores, row-major takes a
CUTLASS fallback several times slower (`python3 -m
grove_tpu_torch.profile_towers` times both at the towers' shapes). So on
the card a row-major b raises: a loader or copy that lost the layout fails
loudly instead of slowing the towers down. On the CPU either layout is
taken and the product is computed in float64, which is exact for
|sum| < 2^53 (here at most K * 127 * 127, under 2^27 at K = 5120), and
returned as int32.
"""

from __future__ import annotations

import torch

from .. import _kernels


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8, contiguous, @ b (K, N) int8 -> (M, N) int32, exact.
    b is column-major (`column_major`); on the CPU row-major is taken too."""
    col = b.t().is_contiguous()
    _kernels.check_typed("int8_matmul", [(a, torch.int8),
                                         (b.t() if col else b, torch.int8)])
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"int8_matmul: {tuple(a.shape)} @ {tuple(b.shape)}")
    if _kernels.on_cpu(a, b):
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    if not col:
        raise ValueError("int8_matmul: b must be column-major on the card "
                         "(ops.int8_matmul.column_major); torch._int_mm "
                         "runs a row-major b on a slow fallback")
    n = b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"int8_matmul: torch._int_mm takes M > 16 and K, N "
                         f"multiples of 8, got M={m}, K={k}, N={n}")
    return torch._int_mm(a, b)


def column_major(b: torch.Tensor) -> torch.Tensor:
    """The same (..., K, N) values with the last two axes stored
    transposed: the layout `torch._int_mm` runs fast."""
    return b.transpose(-1, -2).contiguous().transpose(-1, -2)
