"""Attention ops: the plain fp32-softmax path and the CLIP kernel (K3).

Counterpart of `grove_tpu/ops/attention.py`. All shapes are
(batch, seq, heads, head_dim); softmax runs in fp32 whatever the input
dtype.

* `xla_attention` is the plain version (the name keeps the JAX package's):
  materialized fp32 logits, optional bias and mask. LLaMA prefill and decode
  over the bf16 cache use it directly, as the JAX package does.
* `grouped_plain_attention` is K3, non-causal self-attention over a ragged
  S (CLIP's 577), beside its plain twin `grouped_plain_attention_torch`.
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
