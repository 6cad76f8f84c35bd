"""One decode step of attention over the int8 KV cache (K6).

Counterpart of `grove_tpu/ops/decode_attention.py`. The cache keeps the JAX
package's row-major layout: kt/vt (B, Hkv, C, D) int8 with per-token,
per-head bf16 scales k_s/v_s (B, Hkv, C), C padded to a multiple of 128
(`models.llama.init_kv_caches`). Masked slots carry NEG_INF in the (B, C)
bias.

* `int8_cache_decode_attention` is K6: CPU tensors take
  `int8_cache_decode_attention_torch`, which follows the TPU kernel's
  numerics step by step; CUDA tensors launch
  `csrc/int8_decode_attention.cu`.
* `decode_attention_reference` dequantises and then attends, the oracle the
  JAX package's tests hold the kernel to.

GQA maps query head h to kv head h // (H / Hkv), the reference's
`jnp.repeat` order; the TPU kernel's head permutation
(`decode_attention.py:106-113`) was a layout device and has no counterpart.
"""

from __future__ import annotations

import math

import torch

from .. import _kernels

NEG_INF = -1e9
MAX_HEAD_DIM = 128


def _repeat_heads(x: torch.Tensor, group: int) -> torch.Tensor:
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def int8_cache_decode_attention_torch(q, kt, vt, k_s, v_s, bias):
    """Plain version of K6 with the TPU kernel's numerics
    (`decode_attention.py:45-86`): q quantised per head (absmax / 127,
    floored at 1e-8, rounded half to even, clipped to +-127); an exact
    integer Q.K; logits = ((dot * q_s) * k_s) / sqrt(D) + bias; an fp32
    softmax; w = bf16(p * v_s); out = w . v in fp32, cast to q's dtype."""
    b, h, d = q.shape
    group = h // kt.shape[1]
    qf = q.float()
    qs = (qf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    qi = torch.clamp(torch.round(qf / qs), -127, 127)
    kk = _repeat_heads(kt, group).float()
    # |dot| <= D * 127^2 < 2^24, so the fp32 product sums are exact integers
    dot = torch.einsum("bhd,bhcd->bhc", qi, kk)
    ks = _repeat_heads(k_s, group).float()
    logits = (dot * qs) * ks * (1.0 / math.sqrt(d)) + bias[:, None, :].float()
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = e / e.sum(-1, keepdim=True)
    w = (w * _repeat_heads(v_s, group).float()).to(torch.bfloat16)
    out = torch.einsum("bhc,bhcd->bhd", w.float(),
                       _repeat_heads(vt, group).float())
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
    launch `csrc/int8_decode_attention.cu` (D a multiple of 4 up to 128)."""
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
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} is not a multiple of 4 up "
                         f"to {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["int8_decode_attention"](
            q.data_ptr(), kt.data_ptr(), vt.data_ptr(), k_s.data_ptr(),
            v_s.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, hkv, c,
            d, 1.0 / math.sqrt(d), dt, _kernels.stream_ptr(q))
    return out
