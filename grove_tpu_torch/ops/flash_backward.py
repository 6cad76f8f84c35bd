"""Flash attention forward with LSE output (K4).

Counterpart of `grove_tpu/ops/flash_backward.py:flash_forward_lse`. Only the
forward is ported: the backward kernels (`_dq_kernel`, `_dkv_kernel`) belong
to the training slice (ROADMAP Queue 2, K4b).

The LSE comes back as (B, H, S) fp32. The JAX kernel's (B*H, n_blocks,
block) layout kept row statistics on TPU lanes; a test reshapes it to
compare.
"""

from __future__ import annotations

import torch

from .. import _kernels


def flash_forward_lse_torch(q, k, v, *, causal: bool, scale: float):
    """Plain version of K4: (B, S, H, D) -> (out (B, S, H, D), lse (B, H, S)).

    fp32 throughout, like the TPU kernel (it casts q, k, v to fp32); the
    output is cast back to the input dtype."""
    s = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(s, device=q.device)
        logits = logits.masked_fill(pos[None, :] > pos[:, None],
                                    float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def flash_forward_lse(q, k, v, *, causal: bool, scale: float):
    """K4: (B, S, H, D) -> (out (B, S, H, D), lse (B, H, S) fp32).

    CPU tensors take `flash_forward_lse_torch`; CUDA tensors launch
    `csrc/flash_forward_lse.cu`. Any S is taken (the TPU kernel needed a
    multiple of its block)."""
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_forward_lse: self-attention shapes differ: "
                         f"{q.shape}, {k.shape}, {v.shape}")
    if _kernels.on_cpu(q, k, v):
        return flash_forward_lse_torch(q, k, v, causal=causal, scale=scale)
    dt = _kernels.check_cuda_inputs("flash_forward_lse", (q, k, v), d, b * h)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["flash_forward_lse"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, d, int(bool(causal)), float(scale), dt,
            _kernels.stream_ptr(q))
    return out, lse
