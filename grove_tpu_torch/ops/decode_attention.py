"""One decode step of attention over the int8 KV cache (K6).

Counterpart of `grove_tpu/ops/decode_attention.py`. The cache keeps the JAX
package's row-major layout: kt/vt (B, Hkv, C, D) int8 with per-token,
per-head bf16 scales k_s/v_s (B, Hkv, C), C padded to a multiple of 128
(`models.llama.init_kv_caches`). Masked slots carry NEG_INF in the (B, C)
bias.

* `int8_cache_decode_attention` is K6: CPU tensors take
  `int8_cache_decode_attention_torch`, which follows the TPU kernel's
  numerics step by step; CUDA tensors launch
  `csrc/int8_decode_attention.cu` once, as `_plan` says: one thread-block
  cluster per (batch, kv head) whose ranks split the slots, K and V brought
  into shared memory by TMA bulk copies, the softmax's max and sum combined
  over the ranks in rank order before the TPU kernel's rounding of the
  weights, the ranks' outputs added in rank order.
* `int8_cache_decode_attention_split_torch` is a torch model of that
  split, which the CPU tests hold to the Pallas kernel.
* `decode_attention_reference` dequantises and then attends, the oracle the
  JAX package's tests hold the kernel to.

GQA maps query head h to kv head h // (H / Hkv), the reference's
`jnp.repeat` order; the TPU kernel's head permutation
(`decode_attention.py:106-113`) was a layout device and has no counterpart.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from .. import _kernels

NEG_INF = -1e9
MAX_HEAD_DIM = 128

# K6's launch (`csrc/int8_decode_attention.cu`): 256 threads a CTA, the
# rank's K and V slices brought CHUNK slots a bulk copy through a ring of
# RING buffers (a deeper ring, up to all of a full-width rank's six copies,
# was no faster on an H100 and costs CTAs an SM); a cluster of at most
# MAX_CLUSTER ranks, each with at least MIN_SLOTS slots where it has more
# than one rank
THREADS = 256
WARPS = THREADS // 32
CHUNK = 128
RING = 2
MAX_CLUSTER = 8
MIN_SLOTS = 64
SMEM_LIMIT = 232448          # shared bytes one block can use on sm_90


def _up16(x: int) -> int:
    return -(-x // 16) * 16


def _smem(ring: int, span: int, group: int, d: int) -> int:
    """`layout(...).total` of `csrc/int8_decode_attention.cu`: the ring,
    the logits of each query head, q as it comes (fp32 at most), the rank's
    k_s and v_s in bf16 and bias in fp32, the quantised q and its scales,
    each warp's P.V sums, the rank's output, the statistics the cluster
    reads, a reduction's scratch and the mbarriers (the ring's and the
    small copies')."""
    return (ring * CHUNK * d + _up16(4 * group * span) + 4 * group * d
            + 2 * _up16(2 * span) + _up16(4 * span) + _up16(group * d)
            + _up16(4 * group) + 4 * WARPS * group * d + 4 * group * d
            + 2 * _up16(8 * group) + _up16(4 * WARPS) + 8 * (ring + 1))


def _ranges(c: int, n: int) -> Tuple[Tuple[int, int], ...]:
    """The slots [first, end) of each of n ranks: they split the C / 8
    groups of 8 slots (`rank_start`), so every rank's slices of the cache,
    its scales and the bias lie on 16 bytes."""
    starts = [8 * (c // 8 * r // n) for r in range(n)] + [c]
    return tuple(zip(starts[:-1], starts[1:]))


class DecodePlan(NamedTuple):
    """One K6 launch: `ranges[r]` are the slots [first, end) of cluster
    rank r, as the kernel computes them (`_ranges`)."""
    cluster: int        # ranks splitting the C slots
    ranges: Tuple[Tuple[int, int], ...]
    ring: int           # bulk-copy buffers of CHUNK slots
    span: int           # slots of the longest rank
    smem: int           # dynamic shared bytes per CTA
    ctas: int


@functools.lru_cache(maxsize=None)
def _plan(b: int, h: int, hkv: int, c: int, d: int, sms: int) -> DecodePlan:
    """K6's launch for a (B, H, D) query over a (B, Hkv, C, D) cache on a
    card of `sms` SMs: the cluster of each (batch, kv head) doubles while
    all clusters still fit one wave (B Hkv n <= sms) and each rank keeps at
    least MIN_SLOTS slots (2 at the full width, B Hkv = 64: 128 CTAs on
    132 SMs), and further while a rank's arrays do not fit shared memory.
    Pure, so memoised. Raises ValueError for what the kernel does not take:
    D off a multiple of 16 or above 128, C off a multiple of 8 (the model
    pads it to 128), or a cache too long for shared memory."""
    if d % 16 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"int8_cache_decode_attention: head dim {d} is "
                         f"not a multiple of 16 up to {MAX_HEAD_DIM}")
    if c % 8 or c <= 0:
        raise ValueError(f"int8_cache_decode_attention: {c} cache slots, "
                         f"not a multiple of 8")
    group = h // hkv

    def span(n):
        return 8 * -(-(c // 8) // n)

    n = 1
    while (2 * n <= MAX_CLUSTER and b * hkv * 2 * n <= sms
           and c // (2 * n) >= MIN_SLOTS):
        n *= 2
    while _smem(RING, span(n), group, d) > SMEM_LIMIT:
        if 2 * n > min(MAX_CLUSTER, c // 8):
            raise ValueError(
                f"int8_cache_decode_attention: a cache of {c} slots at head "
                f"dim {d} and {group} query heads a kv head does not fit "
                f"shared memory")
        n *= 2
    return DecodePlan(n, _ranges(c, n), RING, span(n),
                      _smem(RING, span(n), group, d), b * hkv * n)


def _repeat_heads(x: torch.Tensor, group: int) -> torch.Tensor:
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def _logits(q, kt, k_s, bias):
    """The TPU kernel's logits (`decode_attention.py:45-66`), (B, H, C)
    fp32: q quantised per head (absmax / 127, floored at 1e-8, rounded half
    to even, clipped to +-127); an exact integer Q.K; ((dot * q_s) * k_s) /
    sqrt(D) + bias."""
    d = q.shape[-1]
    group = q.shape[1] // kt.shape[1]
    qf = q.float()
    qs = (qf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    qi = torch.clamp(torch.round(qf / qs), -127, 127)
    kk = _repeat_heads(kt, group).float()
    # |dot| <= D * 127^2 < 2^24, so the fp32 product sums are exact integers
    dot = torch.einsum("bhd,bhcd->bhc", qi, kk)
    ks = _repeat_heads(k_s, group).float()
    return (dot * qs) * ks * (1.0 / math.sqrt(d)) + bias[:, None, :].float()


def int8_cache_decode_attention_torch(q, kt, vt, k_s, v_s, bias):
    """Plain version of K6 with the TPU kernel's numerics
    (`decode_attention.py:45-86`): the logits of `_logits`; an fp32
    softmax; w = bf16(p * v_s); out = w . v in fp32, cast to q's dtype."""
    group = q.shape[1] // kt.shape[1]
    logits = _logits(q, kt, k_s, bias)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = e / e.sum(-1, keepdim=True)
    w = (w * _repeat_heads(v_s, group).float()).to(torch.bfloat16)
    out = torch.einsum("bhc,bhcd->bhd", w.float(),
                       _repeat_heads(vt, group).float())
    return out.to(q.dtype)


def int8_cache_decode_attention_split_torch(
        q, kt, vt, k_s, v_s, bias,
        ranges: Sequence[Tuple[int, int]]):
    """A model of K6's cluster split, in torch ops: the logits of
    `_logits`; each rank (slots [first, end) of `ranges`) takes its max,
    the global max is the ranks' maximum; e = exp(l - max) and each rank
    its sum, the global sum the ranks' sums added in rank order; w =
    bf16(e / sum * v_s), the TPU kernel's rounding; each rank's P.V in fp32
    and the ranks' outputs added in rank order."""
    group = q.shape[1] // kt.shape[1]
    logits = _logits(q, kt, k_s, bias)
    parts = [logits[..., s0:s1] for s0, s1 in ranges]
    top = torch.stack([p.amax(-1) for p in parts]).amax(0)[..., None]
    es = [torch.exp(p - top) for p in parts]
    total = torch.zeros_like(top)
    for e in es:
        total = total + e.sum(-1, keepdim=True)
    vs = _repeat_heads(v_s, group).float()
    vv = _repeat_heads(vt, group).float()
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for (s0, s1), e in zip(ranges, es):
        w = (e / total * vs[..., s0:s1]).to(torch.bfloat16).float()
        out = out + torch.einsum("bhc,bhcd->bhd", w, vv[:, :, s0:s1])
    return out.to(q.dtype)


def decode_attention_reference(q, kt, vt, k_s, v_s, bias):
    """Dequantise-then-attend oracle (`decode_attention.py:143-156`)."""
    b, h, d = q.shape
    group = h // kt.shape[1]
    kk = _repeat_heads(kt.float() * k_s[..., None].float(), group)
    vv = _repeat_heads(vt.float() * v_s[..., None].float(), group)
    logits = torch.einsum("bhd,bhcd->bhc", q.float(), kk)
    logits = logits / math.sqrt(d) + bias[:, None, :].float()
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhc,bhcd->bhd", w, vv).to(q.dtype)


def int8_cache_decode_attention(q, kt, vt, k_s, v_s, bias):
    """K6. q (B, H, D) float32 or bf16, RoPE applied; kt/vt (B, Hkv, C, D)
    int8; k_s/v_s (B, Hkv, C) bf16; bias (B, C) fp32 (0 valid, NEG_INF
    masked). Returns (B, H, D) in q's dtype.

    CPU tensors take `int8_cache_decode_attention_torch`; CUDA tensors
    launch `csrc/int8_decode_attention.cu` once, as `_plan` says (D a
    multiple of 16 up to 128, C of 8; every tensor on 16 bytes, as the
    bulk copies need)."""
    b, h, d = q.shape
    hkv, c = kt.shape[1], kt.shape[2]
    if (kt.shape != (b, hkv, c, d) or vt.shape != kt.shape
            or k_s.shape != (b, hkv, c) or v_s.shape != k_s.shape
            or bias.shape != (b, c) or h % hkv):
        raise ValueError(
            f"int8_cache_decode_attention: q {tuple(q.shape)}, kt "
            f"{tuple(kt.shape)}, vt {tuple(vt.shape)}, k_s "
            f"{tuple(k_s.shape)}, v_s {tuple(v_s.shape)}, bias "
            f"{tuple(bias.shape)}")
    if _kernels.on_cpu(q, kt, vt, k_s, v_s, bias):
        return int8_cache_decode_attention_torch(q, kt, vt, k_s, v_s, bias)
    name = "int8_cache_decode_attention"
    dt = _kernels.dtype_code(name, q)
    _kernels.check_typed(name, [(q, q.dtype), (kt, torch.int8),
                                (vt, torch.int8), (k_s, torch.bfloat16),
                                (v_s, torch.bfloat16),
                                (bias, torch.float32)])
    p = _plan(b, h, hkv, c, d, _kernels.sm_count(q.device))
    if any(t.data_ptr() % 16 for t in (q, kt, vt, k_s, v_s, bias)):
        raise ValueError(f"{name}: every tensor must lie on 16 bytes")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["int8_decode_attention"](
            q.data_ptr(), kt.data_ptr(), vt.data_ptr(), k_s.data_ptr(),
            v_s.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, hkv, c,
            d, p.cluster, p.ring, 1.0 / math.sqrt(d), dt,
            _kernels.stream_ptr(q))
    return out

