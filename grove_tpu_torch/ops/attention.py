"""Attention ops: the plain fp32-softmax path, the CLIP kernel (K3) and
the raw-layout causal prefill kernel (K5).

Counterpart of `grove_tpu/ops/attention.py`. All shapes are
(batch, seq, heads, head_dim); softmax runs in fp32 whatever the input
dtype.

* `xla_attention` is the plain version (the name keeps the JAX package's):
  materialized fp32 logits, optional bias and mask. LLaMA prefill and decode
  over the bf16 cache use it directly, as the JAX package does.
* `grouped_plain_attention` is K3, non-causal self-attention over a ragged
  S (CLIP's 577), beside its plain twin `grouped_plain_attention_torch`.
* `prefill_attention_raw` is K5, causal self-attention with a per-sample
  left pad in the raw (B, S, H*D) projection layout (the int8-cache
  prefill), beside `prefill_attention_raw_torch`;
  `prefill_attention_trainable` is its pure-causal forward for the
  cache-free pass at a ragged S.
* `multi_head_attention` dispatches by the tensors' device only: the
  wrappers below take their plain version for CPU tensors and launch the
  kernel for CUDA tensors. The TPU rules for VMEM size and lane alignment
  (`_grouped_plain_ok`, `prefill_attention_ok`) have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _kernels

NEG_INF = -1e30          # grove_tpu/ops/attention.py:63, K5's masked logit


def xla_attention(q, k, v, *, causal: bool = False,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention. q: (B, Sq, H, D); k/v: (B, Sk, H, D).

    bias: broadcastable to (B, H, Sq, Sk), added before the softmax.
    mask: broadcastable to (B, H, Sq, Sk) bool; False = masked out.
    Logits and softmax in fp32; P.V in the input dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dtype = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v)


def grouped_plain_attention_torch(q, k, v, *,
                                  scale: Optional[float] = None):
    """Plain version of K3: `xla_attention` without mask or bias
    (max-subtracted fp32 softmax)."""
    return xla_attention(q, k, v, scale=scale)


def grouped_plain_attention(q, k, v, *, scale: Optional[float] = None):
    """K3: non-causal self-attention, (B, S, H, D) -> (B, S, H, D).

    CPU tensors take `grouped_plain_attention_torch`; CUDA tensors launch
    `csrc/grouped_plain_attention.cu`, which masks the ragged edge in the
    kernel (no padded copies)."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"grouped_plain_attention: self-attention shapes "
                         f"differ: {q.shape}, {k.shape}, {v.shape}")
    if _kernels.on_cpu(q, k, v):
        return grouped_plain_attention_torch(q, k, v, scale=scale)
    dt = _kernels.check_cuda_inputs("grouped_plain_attention", (q, k, v),
                                    d, b * h)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["grouped_plain_attention"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, d, float(scale), dt, _kernels.stream_ptr(q))
    return out


def multi_head_attention(q, k, v, *, causal: bool = False,
                         bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Dispatching attention entry point. Shapes (B, S, H, D).

    With a bias or mask: `xla_attention`. Causal: the flash forward (K4,
    `ops.flash_backward.flash_forward_lse`). Otherwise self-attention: K3.
    K3 and K4 pick kernel or plain version by the tensors' device."""
    if bias is not None or mask is not None:
        return xla_attention(q, k, v, causal=causal, bias=bias, mask=mask,
                             scale=scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if causal:
        from .flash_backward import flash_forward_lse
        return flash_forward_lse(q, k, v, causal=True, scale=scale)[0]
    return grouped_plain_attention(q, k, v, scale=scale)


def prefill_attention_raw_torch(q, k, v, pad_lens, num_heads: int,
                                scale: float):
    """Plain version of K5 with the TPU kernel's numerics
    (`grove_tpu/ops/attention.py:197-226`): fp32 logits, invalid slots set
    to NEG_INF, one softmax over the full S, p cast to the input dtype
    before P.V (fp32 accumulation) and the fp32 sum of p, floored at 1e-30,
    as the denominator. Valid: (k <= q) & ((k >= pad) | (k == q))."""
    b, s, c = q.shape
    hd = c // num_heads
    qh, kh, vh = (t.reshape(b, s, num_heads, hd) for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * scale
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    pad = pad_lens.long()[:, None, None, None]
    valid = (kpos <= qpos) & ((kpos >= pad) | (kpos == qpos))
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), vh.float())
    out = out / denom.permute(0, 2, 1, 3)
    return out.to(q.dtype).reshape(b, s, c)


def prefill_attention_raw(q, k, v, pad_lens, num_heads: int, scale: float):
    """K5: causal self-attention over fresh q/k/v in the raw (B, S, H*D)
    layout; pad_lens (B,) counts each sample's leading masked key slots
    (0 = pure causal). Returns (B, S, H*D).

    CPU tensors take `prefill_attention_raw_torch`; CUDA tensors launch
    `csrc/prefill_attention.cu`, which reads the heads in place."""
    b, s, c = q.shape
    if k.shape != q.shape or v.shape != q.shape or c % num_heads:
        raise ValueError(f"prefill_attention_raw: q/k/v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} with "
                         f"{num_heads} heads")
    if tuple(pad_lens.shape) != (b,):
        raise ValueError(f"prefill_attention_raw: pad_lens "
                         f"{tuple(pad_lens.shape)} for batch {b}")
    if _kernels.on_cpu(q, k, v, pad_lens):
        return prefill_attention_raw_torch(q, k, v, pad_lens, num_heads,
                                           scale)
    hd = c // num_heads
    dt = _kernels.check_cuda_inputs("prefill_attention_raw", (q, k, v), hd,
                                    b * num_heads)
    pad = pad_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["prefill_attention"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            out.data_ptr(), b, s, num_heads, hd, float(scale), dt,
            _kernels.stream_ptr(q))
    return out


def prefill_attention_trainable(q, k, v, num_heads: int, scale: float):
    """Forward of the JAX package's `prefill_attention_trainable`: K5 with
    no pad, for the cache-free pass at an S that is not a multiple of 64.
    Its backward belongs to the training slice."""
    pad = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    return prefill_attention_raw(q, k, v, pad, num_heads, scale)
