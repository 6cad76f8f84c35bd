"""The int8 x int8 product of the W8A8 layers, with int32 accumulation.

The JAX package computes it in XLA, outside any Pallas kernel
(`grove_tpu/models/layers.py:113-116`, `:529-533`: `dot_general` with
`preferred_element_type=float32`), so there is no TPU kernel to port here.
On the card it is `torch._int_mm` (int32 accumulation on the int8 tensor
cores), which takes M > 16 and K, N multiples of 8 only; the wrapper
zero-pads the operands to those shapes and slices the product back. The
padding adds zero terms, so the product stays exact, bit-equal to the JAX
package's at every shape (lm_head's N = 32007, a decode batch's M = 2).

Its speed depends on the layout of b: column-major (the bytes of the (N, K)
transpose, as the W8A8 modules store their weights, `column_major`) runs on
the tensor cores, row-major takes a CUTLASS fallback several times slower
(`python3 -m grove_tpu_torch.profile_towers` times both at the towers'
shapes). So on the card a row-major b raises: a loader or copy that lost
the layout fails loudly instead of slowing the towers down. `column_major`
also rounds N up to a multiple of 8 in the weight's storage, so lm_head's
(4096, 32007) weight is padded once, when it is laid out, and the product
reads the padded columns in place; a b without that room (one moved by
`.to()`, which copies only the (K, N) view) is padded on every call.

On the CPU either layout is taken and the product is computed in float64,
which is exact for |sum| < 2^53 (here at most K * 127 * 127, under 2^27 at
K = 5120), and returned as int32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _kernels

MIN_ROWS = 17            # torch._int_mm takes M > 16
PADDED_ROWS = 32         # the M a smaller product is padded to


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _padded_b(b: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """Column-major (kp, np_) int8 holding b in its top-left corner: b's
    own storage where `column_major` left room for it, else a zero-padded
    copy. What lies past b's N columns never reaches the sliced product."""
    k, n = b.shape
    room = b.untyped_storage().nbytes() - b.storage_offset()
    if kp == k and room >= np_ * k:
        return torch.as_strided(b, (k, np_), (1, k))
    out = torch.zeros((np_, kp), dtype=torch.int8, device=b.device)
    out[:n, :k] = b.t()
    return out.t()


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8, contiguous, @ b (K, N) int8 -> (M, N) int32, exact,
    at any M, K, N. b is column-major (`column_major`); on the CPU
    row-major is taken too."""
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
    mp = m if m >= MIN_ROWS else PADDED_ROWS
    kp, np_ = _round8(k), _round8(n)
    if (mp, kp, np_) == (m, k, n):
        return torch._int_mm(a, b)
    ap = F.pad(a, (0, kp - k, 0, mp - m))
    return torch._int_mm(ap, _padded_b(b, kp, np_))[:m, :n]


def column_major(b: torch.Tensor) -> torch.Tensor:
    """The same (..., K, N) values with the last two axes stored
    transposed: the layout `torch._int_mm` runs fast. For a 2-D b the
    storage holds N rounded up to a multiple of 8 (zeros past N), which
    `int8_matmul` reads in place instead of padding b on every call."""
    if b.dim() != 2 or b.shape[1] % 8 == 0:
        return b.transpose(-1, -2).contiguous().transpose(-1, -2)
    k, n = b.shape
    buf = torch.zeros((_round8(n), k), dtype=b.dtype, device=b.device)
    buf[:n] = b.t()
    return buf[:n].t()
