"""SAM decomposed-rel-pos flash attention for training: K9.

Counterpart of `grove_tpu/ops/sam_attention_bwd.py`. Forward logits

    s_ij = scale * q_i . k_j + rh[i, kh(j)] + rw[i, kw(j)],
    rh = einsum(q, Rh), rw = einsum(q, Rw)   (`relpos_terms`, unscaled q)

and, with ds = p * (dO . v - D):

    dv_j      = sum_i p_ij dO_i
    dk_j      = scale * sum_i ds_ij q_i
    d_rh[i,a] = sum_{j: kh(j)=a} ds_ij,   d_rw[i,b] = sum_{j: kw(j)=b} ds_ij
    dq_i      = scale * sum_j ds_ij k_j + einsum(d_rh, Rh) + einsum(d_rw, Rw)
    dRh, dRw  = einsum(d_rh, q), einsum(d_rw, q) scattered into the tables.

Three kernels (`csrc/relpos_flash_attention.cu`), each with a plain twin
that spells out the formula:

* `relpos_flash_fwd_lse`: out and the (B, H, S) fp32 LSE, on the
  tensor-core body for bf16 at head dims 64, 80, 128, the SIMT body
  otherwise;
* `relpos_flash_dq`: dq's attention part and the per-row term gradients
  d_rh (B, H, S, gh), d_rw (B, H, S, gw), fp32;
* `relpos_flash_dkv`: dk, dv, on the tensor-core backward body for bf16
  at head dims 64, 80, 128 (`relpos_flash_dkv_tc_torch` is its arithmetic,
  P and dS rounded to bf16 where the TPU kernel rounds them), the SIMT body
  otherwise.

`relpos_flash_bwd` adds what the JAX package computes in XLA, here in torch
ops: D = rowsum(dO * O), the rel terms, dq's bias part and the table
gradients (only those asked for: the tables are frozen in the default
freeze policy). `relpos_flash_attention` is the `jax.custom_vjp` as a
`torch.autograd.Function`; `relpos_vjp` is the backward that K1's and K2's
Functions (`ops.sam_attention`) delegate to: it recomputes the forward with
its LSE (K9's max-subtracted softmax, not K1's EXP2_SHIFT one, as in the
JAX package), then runs the backward.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import _kernels
from .attention import LOG2E, _tc_takes
from .flash_backward import _ds, row_dot
from .sam_attention import _expand_bias, relpos_terms
from .sam_encoder_tables import gather_rel_tables, rel_pos_index

MAX_REL = 64          # gh + gw the dq kernel takes: two buckets per lane


def _relpos_logits(q, k, rel_h_term, rel_w_term, scale: float):
    acc = _kernels.acc_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    return logits + _expand_bias(rel_h_term, rel_w_term).to(acc)


def _check(name: str, q, k, v, rel_h_term, rel_w_term, hw):
    gh, gw = hw
    b, s, h, d = q.shape
    if s != gh * gw or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q/k/v {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match grid {hw}")
    if (rel_h_term.shape != (b, h, s, gh)
            or rel_w_term.shape != (b, h, s, gw)):
        raise ValueError(f"{name}: rel terms {tuple(rel_h_term.shape)}, "
                         f"{tuple(rel_w_term.shape)}")


def relpos_flash_fwd_lse_torch(q, k, v, rel_h_term, rel_w_term,
                               hw: Tuple[int, int], scale: float):
    """Plain version of K9's forward: (out (B, S, H, D) in q's dtype,
    lse (B, H, S)), fp32 (float64 for float64 inputs)."""
    logits = _relpos_logits(q, k, rel_h_term, rel_w_term, scale)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype))
    return out.to(q.dtype), lse


def relpos_flash_fwd_lse(q, k, v, rel_h_term, rel_w_term,
                         hw: Tuple[int, int], scale: float):
    """K9 forward (`relpos_flash_fwd_lse`, `sam_attention_bwd.py:229-272`):
    q/k/v (B, S, H, D), terms as from `relpos_terms` -> (out, lse (B, H, S)
    fp32). CPU tensors take the twin; CUDA tensors launch
    `grove_relpos_flash_fwd_lse_tc` (the tensor-core body) where
    `ops.attention._tc_takes` holds (bf16 at D 64, 80, 128: every bf16
    training step) and `grove_relpos_flash_fwd_lse` (the SIMT body)
    otherwise; both keep the LSE over the fp32 probabilities, which dq and
    dkv read back. Any grid is taken (the TPU kernel picked a key block
    that divides S, `_pick_block`)."""
    _check("relpos_flash_fwd_lse", q, k, v, rel_h_term, rel_w_term, hw)
    if _kernels.on_cpu(q, k, v, rel_h_term, rel_w_term):
        return relpos_flash_fwd_lse_torch(q, k, v, rel_h_term, rel_w_term,
                                          hw, scale)
    name = ("relpos_flash_fwd_lse_tc" if _tc_takes(q.dtype, q.shape[-1])
            else "relpos_flash_fwd_lse")
    return _fwd_launch(name, q, k, v, rel_h_term, rel_w_term, hw, scale)


def _fwd_launch(name: str, q, k, v, rel_h_term, rel_w_term,
                hw: Tuple[int, int], scale: float):
    """Launch the K9 forward entry `name` on CUDA tensors."""
    gh, gw = hw
    b, s, h, d = q.shape
    dt = _kernels.check_cuda_inputs(name, (q, k, v, rel_h_term, rel_w_term),
                                    d, b * h)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        _kernels.KERNELS[name](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h_term.data_ptr(),
            rel_w_term.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h,
            d, gh, gw, float(scale), dt, _kernels.stream_ptr(q))
    return out, lse


def _relpos_p_ds(q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                 scale: float):
    logits = _relpos_logits(q, k, rel_h_term, rel_w_term, scale)
    p = torch.exp(logits - lse.to(logits.dtype)[..., None])
    return p, _ds(p, g, v, dcap)


def relpos_flash_dq_torch(q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                          hw: Tuple[int, int], scale: float):
    """Plain version of K9's dq: (scale * sum_j ds_ij k_j in q's dtype,
    d_rh (B, H, S, gh), d_rw (B, H, S, gw) in fp32 or float64)."""
    gh, gw = hw
    p, ds = _relpos_p_ds(q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                         scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ds.dtype)) * scale
    grid = ds.reshape(*ds.shape[:3], gh, gw)
    return dq.to(q.dtype), grid.sum(-1), grid.sum(-2)


def relpos_flash_dkv_torch(q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                           hw: Tuple[int, int], scale: float):
    """Plain version of K9's dk, dv: scale * sum_i ds_ij q_i and
    sum_i p_ij dO_i, in k's dtype."""
    p, ds = _relpos_p_ds(q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                         scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ds.dtype)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def relpos_flash_dkv_tc_torch(q, k, v, rel_h_term, rel_w_term, g, lse,
                              dcap, hw: Tuple[int, int], scale: float):
    """The tensor-core dkv body's arithmetic (`csrc/attention_bwd_tc.cuh`)
    in torch ops: fp32 S^T = K.Q^T and dP^T = V.dO^T from the input values;
    x = S^T * (scale * log2(e)) + (rel_h + rel_w) * log2(e) - lse * log2(e)
    in fp32, P^T = exp2(x), dS^T = P^T (dP^T - D) from the unrounded P;
    then P^T and dS^T rounded to bf16 (the TPU kernel's `p.astype(dt)` and
    `ds.astype(dt)`, `sam_attention_bwd.py:186`, `:191`) before the fp32
    products dv = P^T.dO and dk = dS^T.Q, dk times scale; both in k's
    dtype. No path of the port calls it: the plain version the card holds
    the `_tc` entry to."""
    gw = hw[1]
    f32 = torch.float32
    qf, kf, vf, gf = (t.to(f32).permute(0, 2, 1, 3) for t in (q, k, v, g))
    dev = qf.device
    sl2 = torch.tensor(scale, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    log2e = torch.tensor(LOG2E, dtype=f32, device=dev)
    keys = torch.arange(kf.shape[2], device=dev)
    bias = (rel_h_term.to(f32)[..., keys // gw]
            + rel_w_term.to(f32)[..., keys % gw])       # (B, H, Sq, Sk)
    st = kf @ qf.transpose(-1, -2)                      # (B, H, Sk, Sq)
    x = (st * sl2.to(dev) + bias.transpose(-1, -2) * log2e
         - lse.to(f32)[:, :, None, :] * log2e)
    p = torch.exp2(x)
    dp = vf @ gf.transpose(-1, -2)
    ds = p * (dp - dcap.to(f32)[:, :, None, :])
    bf = torch.bfloat16
    dv = p.to(bf).to(f32) @ gf
    dk = (ds.to(bf).to(f32) @ qf) * torch.tensor(scale, dtype=f32)
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _check_bwd(name, q, k, v, rel_h_term, rel_w_term, g, lse, dcap, hw):
    _check(name, q, k, v, rel_h_term, rel_w_term, hw)
    b, s, h, _ = q.shape
    if g.shape != q.shape or lse.shape != (b, h, s) or dcap.shape != (b, h,
                                                                      s):
        raise ValueError(f"{name}: dO {tuple(g.shape)}, lse "
                         f"{tuple(lse.shape)}, D {tuple(dcap.shape)}")


def _cuda_check(name, q, k, v, rel_h_term, rel_w_term, g, lse, dcap):
    b, s, h, d = q.shape
    dt = _kernels.check_cuda_inputs(name, (q, k, v, rel_h_term, rel_w_term,
                                           g), d, b * h)
    _kernels.check_typed(name, [(lse, torch.float32), (dcap, torch.float32)])
    return dt


def relpos_flash_dq(q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                    hw: Tuple[int, int], scale: float):
    """K9 dq (`_dq_kernel`): -> (dq (B, S, H, D) in q's dtype, d_rh, d_rw
    fp32). CPU tensors take the twin; CUDA tensors launch
    `grove_relpos_flash_dq`, which takes gh + gw <= MAX_REL."""
    _check_bwd("relpos_flash_dq", q, k, v, rel_h_term, rel_w_term, g, lse,
               dcap, hw)
    if _kernels.on_cpu(q, k, v, rel_h_term, rel_w_term, g, lse, dcap):
        return relpos_flash_dq_torch(q, k, v, rel_h_term, rel_w_term, g, lse,
                                     dcap, hw, scale)
    gh, gw = hw
    if gh + gw > MAX_REL:
        raise ValueError(f"relpos_flash_dq: grid {hw}: the kernel takes "
                         f"gh + gw <= {MAX_REL}")
    b, s, h, d = q.shape
    dt = _cuda_check("relpos_flash_dq", q, k, v, rel_h_term, rel_w_term, g,
                     lse, dcap)
    dq = torch.empty_like(q)
    f32 = dict(device=q.device, dtype=torch.float32)
    d_rh, d_rw = torch.empty((b, h, s, gh), **f32), torch.empty((b, h, s, gw),
                                                               **f32)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["relpos_flash_dq"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h_term.data_ptr(),
            rel_w_term.data_ptr(), g.data_ptr(), lse.data_ptr(),
            dcap.data_ptr(), dq.data_ptr(), d_rh.data_ptr(), d_rw.data_ptr(),
            b, s, h, d, gh, gw, float(scale), dt, _kernels.stream_ptr(q))
    return dq, d_rh, d_rw


def relpos_flash_dkv(q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                     hw: Tuple[int, int], scale: float):
    """K9 dk, dv (`_dkv_kernel`). CPU tensors take the twin; CUDA tensors
    launch `grove_relpos_flash_dkv_tc` (the tensor-core backward body)
    where `ops.attention._tc_takes` holds (bf16 at D 64, 80, 128: every
    bf16 training step) and the term tables suit its copies
    (`_tables_aligned`), and `grove_relpos_flash_dkv` (the SIMT body)
    otherwise."""
    _check_bwd("relpos_flash_dkv", q, k, v, rel_h_term, rel_w_term, g, lse,
               dcap, hw)
    if _kernels.on_cpu(q, k, v, rel_h_term, rel_w_term, g, lse, dcap):
        return relpos_flash_dkv_torch(q, k, v, rel_h_term, rel_w_term, g,
                                      lse, dcap, hw, scale)
    tc = (_tc_takes(q.dtype, q.shape[-1])
          and _tables_aligned(rel_h_term, rel_w_term))
    name = "relpos_flash_dkv_tc" if tc else "relpos_flash_dkv"
    return _dkv_launch(name, q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                       hw, scale)


def _tables_aligned(*tables) -> bool:
    """Whether each (batch, head) block of the contiguous (B, H, S, g) term
    tables starts 16-byte aligned, as the tensor-core dkv body's 16-byte
    copies need: S g a multiple of 8 bf16 values. Every grid of SAM's
    configurations (2, 8, 14, 16, 32) gives it; an odd one (7 x 7) does
    not and takes the SIMT body."""
    return all(t.data_ptr() % 16 == 0 and t[0, 0].numel() % 8 == 0
               for t in tables)


def _dkv_launch(name: str, q, k, v, rel_h_term, rel_w_term, g, lse, dcap,
                hw: Tuple[int, int], scale: float):
    """Launch the K9 dkv entry `name` on CUDA tensors."""
    gh, gw = hw
    b, s, h, d = q.shape
    dt = _cuda_check(name, q, k, v, rel_h_term, rel_w_term, g, lse, dcap)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _kernels.KERNELS[name](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h_term.data_ptr(),
            rel_w_term.data_ptr(), g.data_ptr(), lse.data_ptr(),
            dcap.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d, gh,
            gw, float(scale), dt, _kernels.stream_ptr(q))
    return dk, dv


def _table_grad(grad, size: int, table):
    """Scatter (g, g, D) gathered-table gradients back into the (L, D)
    table through `rel_pos_index`, as a 0/1 product (deterministic, unlike
    an atomic index_add on the card)."""
    idx = torch.from_numpy(rel_pos_index(size, size)).to(table.device)
    onehot = F.one_hot(idx.reshape(-1), table.shape[0]).to(grad.dtype)
    return (onehot.t() @ grad.reshape(-1, grad.shape[-1])).to(table.dtype)


def relpos_terms_contiguous(q, rel_pos_h, rel_pos_w, hw):
    rh, rw = relpos_terms(q, rel_pos_h, rel_pos_w, hw)
    return rh.contiguous(), rw.contiguous()


def relpos_flash_bwd(q, k, v, rel_pos_h, rel_pos_w, out, lse, g,
                     hw: Tuple[int, int], scale: float,
                     tables: Sequence[bool] = (True, True)):
    """`relpos_flash_bwd` (`sam_attention_bwd.py:275-393`) -> (dq, dk, dv,
    dRh, dRw); a table gradient is None unless `tables` asks for it."""
    b, s, h, d = q.shape
    gh, gw = hw
    acc = _kernels.acc_dtype(q)
    g = g.contiguous()
    dcap = row_dot(out, g)
    rh, rw = relpos_terms_contiguous(q, rel_pos_h, rel_pos_w, hw)
    dq, d_rh, d_rw = relpos_flash_dq(q, k, v, rh, rw, g, lse, dcap, hw,
                                     scale)
    dk, dv = relpos_flash_dkv(q, k, v, rh, rw, g, lse, dcap, hw, scale)

    # q also feeds the bias: dq += einsum(d_rh, Rh) + einsum(d_rw, Rw)
    Rh, Rw = gather_rel_tables(rel_pos_h, rel_pos_w, gh, gw)
    r_drh = d_rh.to(acc).reshape(b, h, gh, gw, gh)
    r_drw = d_rw.to(acc).reshape(b, h, gh, gw, gw)
    dq_extra = (torch.einsum("bnhwk,hkc->bhwnc", r_drh, Rh.to(acc))
                + torch.einsum("bnhwk,wkc->bhwnc", r_drw, Rw.to(acc)))
    dq = (dq.to(acc) + dq_extra.reshape(b, s, h, d)).to(q.dtype)

    d_tables = [None, None]
    if any(tables):
        r_q = q.to(acc).reshape(b, gh, gw, h, d)
        if tables[0]:
            d_tables[0] = _table_grad(
                torch.einsum("bnhwk,bhwnc->hkc", r_drh, r_q), gh, rel_pos_h)
        if tables[1]:
            d_tables[1] = _table_grad(
                torch.einsum("bnhwk,bhwnc->wkc", r_drw, r_q), gw, rel_pos_w)
    return (dq, dk, dv, *d_tables)


def relpos_vjp(q, k, v, rel_pos_h, rel_pos_w, hw: Tuple[int, int], g,
               tables: Sequence[bool] = (True, True)):
    """Gradients of rel-pos attention at (q, k, v, tables) for the
    cotangent g (B, S, H, D): K9's forward recomputes out and the LSE, then
    `relpos_flash_bwd`. The backward of K1 and K2 (`_fused_qkv_bwd`,
    `_grouped_bwd` in the JAX package)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    rh, rw = relpos_terms_contiguous(q, rel_pos_h, rel_pos_w, hw)
    out, lse = relpos_flash_fwd_lse(q, k, v, rh, rw, hw, scale)
    return relpos_flash_bwd(q, k, v, rel_pos_h, rel_pos_w, out, lse, g, hw,
                            scale, tables)


class _RelposFlashAttention(torch.autograd.Function):
    """`relpos_flash_attention` (`sam_attention_bwd.py:400-425`): forward
    K9 with its LSE, saving q, k, v, the tables, out and the LSE; backward
    `relpos_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, rel_pos_h, rel_pos_w, hw):
        scale = 1.0 / math.sqrt(q.shape[-1])
        rh, rw = relpos_terms_contiguous(q, rel_pos_h, rel_pos_w, hw)
        out, lse = relpos_flash_fwd_lse(q, k, v, rh, rw, hw, scale)
        ctx.save_for_backward(q, k, v, rel_pos_h, rel_pos_w, out, lse)
        ctx.hw = hw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_pos_h, rel_pos_w, out, lse = ctx.saved_tensors
        grads = relpos_flash_bwd(
            q, k, v, rel_pos_h, rel_pos_w, out, lse, g, ctx.hw,
            1.0 / math.sqrt(q.shape[-1]), ctx.needs_input_grad[3:5])
        return (*grads, None)


def relpos_flash_attention(q, k, v, rel_pos_h, rel_pos_w,
                           hw: Tuple[int, int]):
    """Differentiable SAM rel-pos attention, q unscaled (B, S, H, D) ->
    (B, S, H, D): K9 forward and backward on the card, twins on the CPU."""
    return _RelposFlashAttention.apply(q, k, v, rel_pos_h, rel_pos_w, hw)
