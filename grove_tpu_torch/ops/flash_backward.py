"""Flash attention forward with LSE output (K4), its backward (K4b), and
the autograd Function that joins them.

Counterpart of `grove_tpu/ops/flash_backward.py`:

* `flash_forward_lse` is K4 (`_fwd_kernel`), out and LSE;
* `flash_backward_dq` / `flash_backward_dkv` are K4b (`_dq_kernel`,
  `_dkv_kernel`); `flash_backward` computes D = rowsum(dO * O) in torch ops
  (XLA in the JAX package, `flash_backward.py:247`) and runs both;
* `flash_attention_trainable` is the `jax.custom_vjp` of the JAX package
  as a `torch.autograd.Function`: forward K4, saving q, k, v, out and the
  LSE (never the S x S probabilities); backward K4b.

Each kernel has a plain twin (`*_torch`) with the explicit formula, fp32
(float64 for float64 inputs). The LSE and D are (B, H, S) fp32; the JAX
kernels' (B*H, n_blocks, block) layout kept row statistics on TPU lanes, and
a test reshapes it to compare.
"""

from __future__ import annotations

import torch

from .. import _kernels


def _causal_fill(logits, causal: bool):
    if not causal:
        return logits
    s = logits.shape[-1]
    pos = torch.arange(s, device=logits.device)
    return logits.masked_fill(pos[None, :] > pos[:, None], float("-inf"))


def _logits(q, k, causal: bool, scale: float):
    acc = _kernels.acc_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    return _causal_fill(logits, causal)


def flash_forward_lse_torch(q, k, v, *, causal: bool, scale: float):
    """Plain version of K4: (B, S, H, D) -> (out (B, S, H, D), lse (B, H, S)).

    fp32 throughout, like the TPU kernel (it casts q, k, v to fp32), or
    float64 for float64 inputs; the output is cast back to the input
    dtype."""
    logits = _logits(q, k, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))
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


# ---------------------------------------------------------------------------
# K4b
# ---------------------------------------------------------------------------

def row_dot(out, g):
    """D = rowsum(dO * O): (B, S, H, D) -> (B, H, S), fp32 (float64 for
    float64 inputs), contiguous."""
    acc = _kernels.acc_dtype(out)
    return (out.to(acc) * g.to(acc)).sum(-1).permute(0, 2, 1).contiguous()


def _probs(q, k, lse, causal: bool, scale: float):
    """p = exp(s - lse) from the forward's LSE, (B, H, S, S)."""
    logits = _logits(q, k, causal, scale)
    return torch.exp(logits - lse.to(logits.dtype)[..., None])


def _ds(p, g, v, dcap):
    """ds = p * (dO . v - D), (B, H, S, S)."""
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(p.dtype), v.to(p.dtype))
    return p * (dp - dcap.to(p.dtype)[..., None])


def flash_backward_dq_torch(q, k, v, g, lse, dcap, *, causal: bool,
                            scale: float):
    """Plain version of K4b's dq: scale * sum_j ds_ij k_j, in q's dtype."""
    p = _probs(q, k, lse, causal, scale)
    ds = _ds(p, g, v, dcap)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(p.dtype)) * scale
    return dq.to(q.dtype)


def flash_backward_dkv_torch(q, k, v, g, lse, dcap, *, causal: bool,
                             scale: float):
    """Plain version of K4b's dk, dv: scale * sum_i ds_ij q_i and
    sum_i p_ij dO_i, in k's dtype."""
    p = _probs(q, k, lse, causal, scale)
    ds = _ds(p, g, v, dcap)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(p.dtype)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(name, q, k, v, g, lse, dcap):
    b, s, h, d = q.shape
    if any(t.shape != q.shape for t in (k, v, g)):
        raise ValueError(f"{name}: q/k/v/dO shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(g.shape)}")
    if lse.shape != (b, h, s) or dcap.shape != (b, h, s):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} and D "
                         f"{tuple(dcap.shape)} must be (B, H, S) = "
                         f"{(b, h, s)}")


def _cuda_stats(name, q, k, v, g, lse, dcap):
    """dtype code of q/k/v/dO; lse and D must be contiguous fp32."""
    b, s, h, d = q.shape
    dt = _kernels.check_cuda_inputs(name, (q, k, v, g), d, b * h)
    _kernels.check_typed(name, [(lse, torch.float32), (dcap, torch.float32)])
    return dt


def flash_backward_dq(q, k, v, g, lse, dcap, *, causal: bool, scale: float):
    """K4b dq: (B, S, H, D) in q's dtype. CPU tensors take
    `flash_backward_dq_torch`; CUDA tensors launch `csrc/flash_backward.cu`
    (`grove_flash_backward_dq`)."""
    _check_bwd("flash_backward_dq", q, k, v, g, lse, dcap)
    if _kernels.on_cpu(q, k, v, g, lse, dcap):
        return flash_backward_dq_torch(q, k, v, g, lse, dcap, causal=causal,
                                       scale=scale)
    b, s, h, d = q.shape
    dt = _cuda_stats("flash_backward_dq", q, k, v, g, lse, dcap)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["flash_backward_dq"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dcap.data_ptr(), dq.data_ptr(), b, s, h, d,
            int(bool(causal)), float(scale), dt, _kernels.stream_ptr(q))
    return dq


def flash_backward_dkv(q, k, v, g, lse, dcap, *, causal: bool,
                       scale: float):
    """K4b dk, dv: (B, S, H, D) each. CPU tensors take
    `flash_backward_dkv_torch`; CUDA tensors launch
    `csrc/flash_backward.cu` (`grove_flash_backward_dkv`)."""
    _check_bwd("flash_backward_dkv", q, k, v, g, lse, dcap)
    if _kernels.on_cpu(q, k, v, g, lse, dcap):
        return flash_backward_dkv_torch(q, k, v, g, lse, dcap,
                                        causal=causal, scale=scale)
    b, s, h, d = q.shape
    dt = _cuda_stats("flash_backward_dkv", q, k, v, g, lse, dcap)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["flash_backward_dkv"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dcap.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, d, int(bool(causal)), float(scale), dt,
            _kernels.stream_ptr(q))
    return dk, dv


def flash_backward(q, k, v, out, lse, g, *, causal: bool, scale: float):
    """Flash backward (`flash_backward.py:236-308`): D in torch ops, then
    K4b's dq and dkv. `lse` (B, H, S) from `flash_forward_lse`. Returns
    (dq, dk, dv) in (B, S, H, D)."""
    g = g.contiguous()
    dcap = row_dot(out, g)
    lse = lse.contiguous()
    dq = flash_backward_dq(q, k, v, g, lse, dcap, causal=causal, scale=scale)
    dk, dv = flash_backward_dkv(q, k, v, g, lse, dcap, causal=causal,
                                scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """`flash_attention_trainable` (`flash_backward.py:315-335`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_forward_lse(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, causal=ctx.causal,
                                    scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v, causal: bool, scale: float):
    """Differentiable flash attention, (B, S, H, D) -> (B, S, H, D): K4
    forward and K4b backward on the card, the plain twins on the CPU."""
    return _FlashAttention.apply(q, k, v, causal, scale)
