"""Matmuls over group-pair packed int4 weights: W4A16 (K7a), W4A8 (K7b),
and the int4 -> per-channel int8 requant (K7c).

Counterpart of `grove_tpu/ops/int4_matmul.py`. The weights keep the JAX
package's bytes: wp (K/2, N) int8 packed by `ops.quant.pack_int4` and scale
(K/G, N) fp32, so

    out = x @ dequant(wp),  dequant[k, n] = q4[k, n] * scale[k // G, n].

* `int4_matmul` is K7a: CPU tensors take `int4_matmul_torch`; CUDA tensors
  launch `csrc/int4_matmul.cu` (G a multiple of 32, N of 4).
* `int4_matmul_torch` is the plain twin, the JAX package's grouped einsum
  (`models/layers.py:268-273`): per-group fp32 partial products, times the
  group's scale, summed over groups.
* `int4_matmul_a8` is K7b (`csrc/int4_matmul_a8.cu`): per-token int8
  activations, each group's product exact in int32.
* `int4_requant_int8` is K7c (`csrc/int4_requant.cu`): the int8 view that
  the prefill's int8 GEMM (`ops.int8_matmul`) takes, stored column-major;
  `requant_multipliers` computes its fixed-point factors as
  `models/layers.py:226-227` does.
Each has a plain twin `*_torch` that CPU tensors take.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .int8_matmul import column_major
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


# ---------------------------------------------------------------------------
# K7b: W4A8 matmul
# ---------------------------------------------------------------------------

def int4_matmul_a8_torch(xq, sx, wp, scale, out_dtype=torch.bfloat16):
    """Plain version of K7b: each group's product of int8 activations and
    int4 weights (exact: integers below 2^24, so fp32 holds them), times
    the group's scale in fp32, summed over the groups, times sx, cast to
    `out_dtype`."""
    g = _group(xq, wp, scale)
    m, k = xq.shape
    xg = xq.reshape(m, k // g, g).float()
    acc = torch.einsum("mgk,gkn->mgn", xg, unpack_int4(wp, g).float())
    return ((acc * scale.float()).sum(1) * sx.float()).to(out_dtype)


def int4_matmul_a8(xq, sx, wp, scale, out_dtype=torch.bfloat16):
    """K7b: xq (M, K) int8 with per-token scales sx (M, 1) fp32 @ packed
    int4 wp (K/2, N) int8 with group scales scale (K/G, N) fp32 -> (M, N)
    in `out_dtype` (`int4_matmul.py:338-393`), y ~= (sx * xq) @ dequant(wp).

    CPU tensors take `int4_matmul_a8_torch`; CUDA tensors launch
    `csrc/int4_matmul_a8.cu` (G a multiple of 32, N of 4), which sums each
    group's int8 x int4 products exactly in int32 with `__dp4a`."""
    g = _group(xq, wp, scale)
    m, k = xq.shape
    if sx.shape != (m, 1):
        raise ValueError(f"int4_matmul_a8: sx {tuple(sx.shape)} for M = {m}")
    if _kernels.on_cpu(xq, sx, wp, scale):
        return int4_matmul_a8_torch(xq, sx, wp, scale, out_dtype)
    name = "int4_matmul_a8"
    dt = _kernels.dtype_code(name, out_dtype)
    _kernels.check_typed(name, [(xq, torch.int8), (sx, torch.float32),
                                (wp, torch.int8), (scale, torch.float32)])
    n = wp.shape[1]
    if g % 32 or n % 4 or xq.data_ptr() % 4:
        raise ValueError(f"{name}: group {g} must be a multiple of 32, N = "
                         f"{n} of 4, and xq 4-byte aligned")
    mt, ksplit = _split(m, n, k // (2 * g), xq.device)
    part = torch.empty((ksplit, m, n), device=xq.device, dtype=torch.float32)
    out = torch.empty((m, n), device=xq.device, dtype=out_dtype)
    with torch.cuda.device(xq.device):
        _kernels.KERNELS[name](
            xq.data_ptr(), sx.data_ptr(), wp.data_ptr(), scale.data_ptr(),
            part.data_ptr(), out.data_ptr(), m, k, n, g, mt, ksplit, dt,
            _kernels.stream_ptr(xq))
    return out


# ---------------------------------------------------------------------------
# K7c: packed int4 -> per-channel int8 view
# ---------------------------------------------------------------------------

def requant_multipliers(scale):
    """(s8 (N,) fp32, mult (K/G, N) int32) of the int4 -> int8 requant
    (`models/layers.py:226-227`): s8 = max over groups of the scale * 7/127
    and mult = round(256 * s_g / s8), the fixed-point factor of each group
    to the channel's int8 scale."""
    s8 = scale.float().amax(0) * (7.0 / 127.0)
    mult = torch.round(scale.float() / s8 * 256.0).to(torch.int32)
    return s8, mult


def _requant_group(wp, mult) -> int:
    kh, n = wp.shape
    groups = mult.shape[0]
    if mult.shape != (groups, n) or groups % 2 or kh % (groups // 2):
        raise ValueError(f"int4_requant_int8: wp {tuple(wp.shape)}, mult "
                         f"{tuple(mult.shape)}")
    return 2 * kh // groups


def int4_requant_int8_torch(wp, mult):
    """Plain version of K7c: q8 = (q4 * mult + 128) >> 8 in int32 for each
    nibble plane, cast to int8 (wrapping, as the TPU kernel's astype
    does); the (K, N) result stored column-major, as K7c writes it."""
    g = _requant_group(wp, mult)
    kh, n = wp.shape
    q4 = unpack_int4(wp, g).to(torch.int32)             # (K/G, G, N)
    q8 = ((q4 * mult[:, None, :] + 128) >> 8).to(torch.int8)
    return column_major(q8.reshape(2 * kh, n))


def int4_requant_int8(wp, mult):
    """K7c: packed int4 wp (K/2, N) int8 and fixed-point multipliers mult
    (K/G, N) int32 -> the per-channel int8 view (K, N), stored column-major
    (the bytes of its (N, K) transpose: the layout `ops.int8_matmul` takes
    on the card), `int4_matmul.py:251-283`.

    CPU tensors take `int4_requant_int8_torch`; CUDA tensors launch
    `csrc/int4_requant.cu` (G and N multiples of 64)."""
    g = _requant_group(wp, mult)
    if _kernels.on_cpu(wp, mult):
        return int4_requant_int8_torch(wp, mult)
    name = "int4_requant_int8"
    _kernels.check_typed(name, [(wp, torch.int8), (mult, torch.int32)])
    kh, n = wp.shape
    if g % 64 or n % 64:
        raise ValueError(f"{name}: group {g} and N = {n} must be multiples "
                         "of 64")
    out = torch.empty((n, 2 * kh), device=wp.device, dtype=torch.int8)
    with torch.cuda.device(wp.device):
        _kernels.KERNELS[name](wp.data_ptr(), mult.data_ptr(),
                               out.data_ptr(), kh, n, g,
                               _kernels.stream_ptr(wp))
    return out.t()
