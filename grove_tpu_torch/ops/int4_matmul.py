"""W4A16 matmul over group-pair packed int4 weights (K7a).

Counterpart of `grove_tpu/ops/int4_matmul.py:int4_matmul`. The weights keep
the JAX package's bytes: wp (K/2, N) int8 packed by `ops.quant.pack_int4`
and scale (K/G, N) fp32, so

    out = x @ dequant(wp),  dequant[k, n] = q4[k, n] * scale[k // G, n].

* `int4_matmul` is K7a: CPU tensors take `int4_matmul_torch`; CUDA tensors
  launch `csrc/int4_matmul.cu` (G a multiple of 32, N of 4).
* `int4_matmul_torch` is the plain twin, the JAX package's grouped einsum
  (`models/layers.py:268-273`): per-group fp32 partial products, times the
  group's scale, summed over groups.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .quant import unpack_int4


def _group(x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor) -> int:
    m, k = x.shape
    kh, n = wp.shape
    groups = scale.shape[0]
    if (k != 2 * kh or scale.shape != (groups, n) or groups % 2
            or k % groups):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, wp "
                         f"{tuple(wp.shape)}, scale {tuple(scale.shape)}")
    return k // groups


def int4_matmul_torch(x, wp, scale):
    """Plain version of K7a: x (M, K) @ dequant(wp) -> (M, N) in x's
    dtype, as per-group fp32 partial products scaled and summed."""
    g = _group(x, wp, scale)
    m, k = x.shape
    xg = x.reshape(m, k // g, g).float()
    y = torch.einsum("mgk,gkn->mgn", xg, unpack_int4(wp, g).float())
    return (y * scale.float()).sum(1).to(x.dtype)


def _split(m: int, n: int, supers: int, device) -> tuple:
    """(rows per block, K splits) for the CUDA kernel: a block takes up to
    8 rows of x and 128 columns; K is split until about two blocks per SM
    are in flight."""
    mt = 1
    while mt < min(m, 8):
        mt *= 2
    tiles = -(-n // 128) * -(-m // mt)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return mt, max(1, min(supers, -(-2 * sms // tiles)))


def int4_matmul(x, wp, scale):
    """K7a: x (M, K) float32 or bf16 @ packed int4 wp (K/2, N) int8 with
    scale (K/G, N) fp32 -> (M, N) in x's dtype, fp32 accumulation.

    CPU tensors take `int4_matmul_torch`; CUDA tensors launch
    `csrc/int4_matmul.cu`, which reads the packed bytes once and unpacks
    them in registers."""
    g = _group(x, wp, scale)
    if _kernels.on_cpu(x, wp, scale):
        return int4_matmul_torch(x, wp, scale)
    name = "int4_matmul"
    dt = _kernels.dtype_code(name, x)
    _kernels.check_typed(name, [(x, x.dtype), (wp, torch.int8),
                                (scale, torch.float32)])
    m, k = x.shape
    n = wp.shape[1]
    if g % 32 or n % 4:
        raise ValueError(f"{name}: group {g} must be a multiple of 32 and "
                         f"N = {n} of 4")
    mt, ksplit = _split(m, n, k // (2 * g), x.device)
    part = torch.empty((ksplit, m, n), device=x.device, dtype=torch.float32)
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        _kernels.KERNELS["int4_matmul"](
            x.data_ptr(), wp.data_ptr(), scale.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, k, n, g, mt, ksplit, dt,
            _kernels.stream_ptr(x))
    return out
