"""Matmuls over group-pair packed int4 weights: W4A16 (K7a), W4A8 (K7b),
and the int4 -> per-channel int8 requant (K7c).

Counterpart of `grove_tpu/ops/int4_matmul.py`. The weights keep the JAX
package's bytes: wp (K/2, N) int8 packed by `ops.quant.pack_int4` and scale
(K/G, N) fp32, so

    out = x @ dequant(wp),  dequant[k, n] = q4[k, n] * scale[k // G, n].

* `int4_matmul` is K7a and `int4_matmul_a8` K7b: CPU tensors take their
  plain twins; CUDA tensors launch one kernel template
  (`csrc/int4_matmul.cuh`; G a multiple of 32, N of 4) once, with the
  launch `_plan` chooses: K split over a thread-block cluster by K and G
  alone, so a fused projection sums each column as its unfused part does.
  K7a (`csrc/int4_matmul.cu`) takes bf16 x on the tensor cores (mma.sync)
  and fp32 x in FFMAs; K7b (`csrc/int4_matmul_a8.cu`) per-token int8
  activations on the int8 tensor cores, each group's product exact in
  int32, the per-token scale at the store.
* `int4_matmul_torch` is the plain twin of K7a, the JAX package's grouped
  einsum (`models/layers.py:268-273`): per-group fp32 partial products,
  times the group's scale, summed over groups; `int4_matmul_a8_torch` K7b's.
* `int4_requant_int8` is K7c (`csrc/int4_requant.cu`): the int8 view that
  the prefill's int8 GEMM (`ops.int8_matmul`) takes, stored column-major,
  written by persistent CTAs over 128 x 128 tiles as `_requant_plan` says;
  `requant_multipliers` computes its fixed-point factors as
  `models/layers.py:226-227` does.
Each has a plain twin `*_torch` that CPU tensors take.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

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


# The launch of K7a and K7b (`csrc/int4_matmul.cuh`): a CTA owns TILE_N
# columns and up to 8 rows of x and streams STAGE_ROWS packed rows at a time
# through a ring of STAGES stages of STAGE_BYTES (the weights and the scale
# rows of the up to 4 super-groups the stage overlaps); the super-groups are
# split over a cluster of CLUSTER CTAs. Clusters of 2 and 64-column tiles:
# an H100's GPCs do not hold the 16 clusters of 8 of a 4096-wide output in
# 256-column tiles one CTA an SM, so some SMs took two and set the time
TILE_N = 64
STAGE_ROWS = 128
STAGE_BYTES = STAGE_ROWS * TILE_N + 4 * 2 * TILE_N * 4
STAGES = 4
CLUSTER = 2
SMEM_LIMIT = 232448          # shared bytes one block can use on sm_90


class Int4Plan(NamedTuple):
    """One launch of K7a or K7b. `ranges[r]` are the super-groups [first,
    end) of cluster rank r, as the kernel computes them (`rank_start`)."""
    mt: int             # rows of x per CTA: 1 (fp32 x only), 2, 4 or 8
    tiles: int          # column tiles of TILE_N
    row_blocks: int     # ceil(M / mt)
    cluster: int        # CTAs splitting the super-groups
    ranges: Tuple[Tuple[int, int], ...]
    vec: int            # bytes per weight copy: 16, or 4 where N % 16 or
                        # the weights or scales lie off 16 bytes
    staged: bool        # x copied into shared memory (else read from global)
    smem: int           # dynamic shared bytes per CTA
    per_sm: int         # CTAs an SM takes with the grid spread evenly

    @property
    def ctas(self) -> int:
        return self.tiles * self.cluster * self.row_blocks


def _smem(mt: int, xstride: int, x_bytes: int) -> int:
    """`smem_bytes` of `csrc/int4_matmul.cuh`: the ring, x's rows of
    `xstride` elements, and the CTA's fp32 partial tile."""
    return STAGES * STAGE_BYTES + mt * xstride * x_bytes + 4 * mt * TILE_N


@functools.lru_cache(maxsize=None)
def _plan(m: int, k: int, n: int, g: int, sms: int, x_bytes: int = 2,
          aligned: bool = True) -> Int4Plan:
    """The launch of K7a or K7b for x (m, k) of `x_bytes` per element (K7a:
    bf16 on the tensor cores, fp32 in FFMAs; K7b: int8 on the tensor cores)
    against (k/2, n) packed weights in groups of g, on a card of `sms` SMs
    (which only sets `per_sm`). The split of K depends on
    k and g alone: a cluster of min(CLUSTER, k / 2g) ranks, rank r taking
    the super-groups [S r / C, S (r + 1) / C). `aligned`: the weights and
    scales lie on 16 bytes (then N % 16 == 0 takes 16-byte copies). x is
    staged in shared memory unless its K range does not fit beside the
    ring. Pure, so memoised: a decode step asks for its few plans 224
    times. Raises ValueError for what the kernel does not take: G off a
    multiple of 32, N off a multiple of 4."""
    if g % 32 or n % 4:
        raise ValueError(f"int4_matmul: group {g} must be a multiple of 32 "
                         f"and N = {n} of 4")
    supers = k // (2 * g)
    cluster = min(CLUSTER, supers)
    ranges = tuple((supers * r // cluster, supers * (r + 1) // cluster)
                   for r in range(cluster))
    xstride = -(-supers // cluster) * 2 * g
    mt = 1 if x_bytes == 4 else 2      # the tensor-core Dots take 2 to 8
    while mt < min(m, 8):
        mt *= 2
    tiles, row_blocks = -(-n // TILE_N), -(-m // mt)
    vec = 16 if aligned and n % 16 == 0 else 4
    staged = _smem(mt, xstride, x_bytes) <= SMEM_LIMIT
    if not staged:
        vec = 4
    ctas = tiles * cluster * row_blocks
    return Int4Plan(mt, tiles, row_blocks, cluster, ranges, vec, staged,
                    _smem(mt, xstride if staged else 0, x_bytes),
                    -(-ctas // sms))


def int4_matmul(x, wp, scale):
    """K7a: x (M, K) float32 or bf16 @ packed int4 wp (K/2, N) int8 with
    scale (K/G, N) fp32 -> (M, N) in x's dtype, fp32 accumulation.

    CPU tensors take `int4_matmul_torch`; CUDA tensors launch
    `csrc/int4_matmul.cu` once, as `_plan` says: no scratch tensor, the
    packed bytes read once in a deep cp.async stream and unpacked in
    registers (onto the tensor cores for bf16 x), K split over a
    thread-block cluster whose ranks add their partial sums through
    distributed shared memory in a fixed order."""
    g = _group(x, wp, scale)
    if _kernels.on_cpu(x, wp, scale):
        return int4_matmul_torch(x, wp, scale)
    name = "int4_matmul"
    dt = _kernels.dtype_code(name, x)
    _kernels.check_typed(name, [(x, x.dtype), (wp, torch.int8),
                                (scale, torch.float32)])
    m, k = x.shape
    n = wp.shape[1]
    p = _plan(m, k, n, g, _kernels.sm_count(x.device), x.element_size(),
              aligned=wp.data_ptr() % 16 == 0
              and scale.data_ptr() % 16 == 0)
    if x.data_ptr() % 16:        # the kernel copies x in 16-byte pieces
        x = x.clone()
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        _kernels.KERNELS[name](
            x.data_ptr(), wp.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, g, p.mt, p.cluster, p.vec, int(p.staged), dt,
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


# a group's sum of 16 s, the int8 tensor cores' form of K7b's products,
# stays below 2^24 (exact in fp32) up to this group
A8_MAX_GROUP = 512


def int4_matmul_a8(xq, sx, wp, scale, out_dtype=torch.bfloat16):
    """K7b: xq (M, K) int8 with per-token scales sx (M, 1) fp32 @ packed
    int4 wp (K/2, N) int8 with group scales scale (K/G, N) fp32 -> (M, N)
    in `out_dtype` (`int4_matmul.py:338-393`), y ~= (sx * xq) @ dequant(wp).

    CPU tensors take `int4_matmul_a8_torch`; CUDA tensors launch
    `csrc/int4_matmul_a8.cu` once (G a multiple of 32 up to 512, N of 4),
    with `_plan`'s launch for one byte of x: K7a's template on the int8
    tensor cores, each group's int8 x int4 product exact in int32, no
    scratch tensor, K split by K and G alone (fused = unfused bit for
    bit)."""
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
    if g > A8_MAX_GROUP:
        raise ValueError(f"{name}: group {g} above {A8_MAX_GROUP}")
    p = _plan(m, k, n, g, _kernels.sm_count(xq.device), 1,
              aligned=wp.data_ptr() % 16 == 0
              and scale.data_ptr() % 16 == 0)
    if xq.data_ptr() % 16:       # the kernel copies xq in 16-byte pieces
        xq = xq.clone()
    out = torch.empty((m, n), device=xq.device, dtype=out_dtype)
    with torch.cuda.device(xq.device):
        _kernels.KERNELS[name](
            xq.data_ptr(), sx.data_ptr(), wp.data_ptr(), scale.data_ptr(),
            out.data_ptr(), m, k, n, g, p.mt, p.cluster, p.vec,
            int(p.staged), dt, _kernels.stream_ptr(xq))
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


# The launch of K7c (`csrc/int4_requant.cu`, whose `plan` computes the same):
# a tile is REQUANT_ROWS packed rows of one super-group (64 where G % 128 is
# 64) by REQUANT_TILE_N columns (the last 64 wide where N % 128 is 64),
# streamed by 16-byte cp.async into a ring of REQUANT_STAGES stages (rows
# and the tile's 2 x 128 multipliers) beside a staging tile of the output;
# REQUANT_PER_SM persistent CTAs an SM, CTA b taking tiles b, b + ctas, ...
REQUANT_ROWS = 128
REQUANT_TILE_N = 128
REQUANT_STAGES = 4
REQUANT_PER_SM = 2
REQUANT_SMEM = (REQUANT_STAGES * (REQUANT_ROWS * REQUANT_TILE_N
                                  + 2 * REQUANT_TILE_N * 4)
                + 2 * REQUANT_TILE_N * 128)


class RequantPlan(NamedTuple):
    """One launch of K7c: tile `t` is row tile t // tiles_n (`rows` packed
    rows from t // tiles_n * rows) by column tile t % tiles_n; CTA b walks
    tiles b, b + ctas, ..."""
    rows: int           # packed rows a tile: 128, or 64 where G % 128 is 64
    tiles_n: int        # column tiles of REQUANT_TILE_N (the last may be 64)
    tiles: int
    ctas: int           # persistent CTAs, at most REQUANT_PER_SM an SM
    stages: int
    smem: int           # dynamic shared bytes a CTA


@functools.lru_cache(maxsize=None)
def _requant_plan(kh: int, n: int, g: int, sms: int) -> RequantPlan:
    """The launch of K7c for packed wp (kh, n) in groups of g on a card of
    `sms` SMs, as the C entry makes it (`grove_int4_requant_int8_plan`
    reports the library's). Raises ValueError for what the kernel does not
    take: G or N off a multiple of 64, kh off a multiple of G."""
    if g <= 0 or g % 64 or kh % g or n <= 0 or n % 64:
        raise ValueError(f"int4_requant_int8: group {g} and N = {n} must be "
                         f"multiples of 64 and K / 2 = {kh} of the group")
    rows = REQUANT_ROWS if g % REQUANT_ROWS == 0 else 64
    tiles_n = -(-n // REQUANT_TILE_N)
    tiles = kh // rows * tiles_n
    return RequantPlan(rows, tiles_n, tiles,
                       min(tiles, REQUANT_PER_SM * sms), REQUANT_STAGES,
                       REQUANT_SMEM)


def int4_requant_int8(wp, mult):
    """K7c: packed int4 wp (K/2, N) int8 and fixed-point multipliers mult
    (K/G, N) int32 -> the per-channel int8 view (K, N), stored column-major
    (the bytes of its (N, K) transpose: the layout `ops.int8_matmul` takes
    on the card), `int4_matmul.py:251-283`.

    CPU tensors take `int4_requant_int8_torch`; CUDA tensors launch
    `csrc/int4_requant.cu` once (G and N multiples of 64), as
    `_requant_plan` says."""
    g = _requant_group(wp, mult)
    if _kernels.on_cpu(wp, mult):
        return int4_requant_int8_torch(wp, mult)
    name = "int4_requant_int8"
    _kernels.check_typed(name, [(wp, torch.int8), (mult, torch.int32)])
    kh, n = wp.shape
    _requant_plan(kh, n, g, _kernels.sm_count(wp.device))
    if wp.data_ptr() % 16 or mult.data_ptr() % 16:
        raise ValueError(f"{name}: an input not 16-byte aligned (the kernel "
                         "copies both in 16-byte pieces)")
    out = torch.empty((n, 2 * kh), device=wp.device, dtype=torch.int8)
    with torch.cuda.device(wp.device):
        _kernels.KERNELS[name](wp.data_ptr(), mult.data_ptr(),
                               out.data_ptr(), kh, n, g,
                               _kernels.stream_ptr(wp))
    return out.t()
