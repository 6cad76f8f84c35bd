"""SAM ViTDet attention with decomposed rel-pos bias: K1 and K2.

Counterpart of `grove_tpu/ops/sam_attention.py`. The S x S bias decomposes
as

    bias[(qh, qw), (kh, kw)] = rel_h[(qh, qw), kh] + rel_w[(qh, qw), kw]

with the two term tables computed from the UNSCALED q (`relpos_terms`,
`relpos_terms_raw`, torch ops). The kernels rebuild the bias per (row, key)
from those tables, so the S x S bias never reaches device memory:

* K1 `grouped_window_attention_relpos_v3`: the 28 windowed blocks, on the
  unsplit qkv projection (nW, S, 3C); `sam_window_attention_fused` is the
  model-facing entry (terms + kernel).
* K2 `grouped_window_attention_relpos`: the 4 global blocks over the full
  grid; `sam_attention_with_relpos` is the model-facing entry.

Both model-facing entries are autograd Functions whose backward is K9
(`ops.sam_attention_bwd`), as the JAX package's custom VJPs delegate to
`relpos_flash_attention`.

Each has a plain twin (`*_torch`) that materializes the bias. Wrappers pick
by device: CPU tensors take the plain version, CUDA tensors the kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import _kernels
from .attention import xla_attention
from .sam_encoder_tables import gather_rel_tables

# The TPU K1 takes its softmax as exp2(logit - EXP2_SHIFT) in log2 units
# (grove_tpu/ops/sam_attention.py:29-39), so a row whose largest logit lies
# below EXP2_SHIFT - 126 underflows everywhere and comes out as 0. K1 and its
# plain twin keep that contract; the overflow of terms above
# EXP2_SHIFT + 127 on the TPU is a fault they do not copy.
EXP2_SHIFT = 32.0
LOG2E = 1.4426950408889634


def relpos_terms(q, rel_pos_h, rel_pos_w, hw: Tuple[int, int]):
    """q: (B, S, H, D) unscaled -> (B, H, S, gh), (B, H, S, gw)."""
    h, w = hw
    b, s, nh, d = q.shape
    Rh, Rw = gather_rel_tables(rel_pos_h, rel_pos_w, h, w)
    r_q = q.reshape(b, h, w, nh, d)
    rel_h = torch.einsum("bhwnc,hkc->bnhwk", r_q, Rh.to(q.dtype))
    rel_w = torch.einsum("bhwnc,wkc->bnhwk", r_q, Rw.to(q.dtype))
    return rel_h.reshape(b, nh, s, h), rel_w.reshape(b, nh, s, w)


def relpos_terms_raw(q, rel_pos_h, rel_pos_w, hw: Tuple[int, int],
                     num_heads: int):
    """Rel terms in K1's packed layout. q: (B, S, H*D) raw projection
    output (may be the q third of qkv). Returns (B, S, H*(gh+gw)): per head
    [rel_h_term | rel_w_term]."""
    h, w = hw
    b, s, c = q.shape
    hd = c // num_heads
    Rh, Rw = gather_rel_tables(rel_pos_h, rel_pos_w, h, w)
    r_q = q.reshape(b, h, w, num_heads, hd)
    rel_h = torch.einsum("bxwnc,xkc->bxwnk", r_q, Rh.to(q.dtype))
    rel_w = torch.einsum("bxwnc,wkc->bxwnk", r_q, Rw.to(q.dtype))
    packed = torch.cat([rel_h, rel_w], dim=-1)          # (b,h,w,nh,gh+gw)
    return packed.reshape(b, s, num_heads * (h + w))


def _expand_bias(rel_h_term, rel_w_term):
    """(B, H, S, gh), (B, H, S, gw) -> (B, H, S, gh*gw) additive bias."""
    b, nh, s, gh = rel_h_term.shape
    gw = rel_w_term.shape[-1]
    acc = _kernels.acc_dtype(rel_h_term)
    bias = (rel_h_term.to(acc)[..., :, None]
            + rel_w_term.to(acc)[..., None, :])
    return bias.reshape(b, nh, s, gh * gw)


# ---------------------------------------------------------------------------
# K2: global blocks
# ---------------------------------------------------------------------------

def grouped_window_attention_relpos_torch(q, k, v, rel_h_term, rel_w_term,
                                          hw: Tuple[int, int]):
    """Plain version of K2: materialized bias + max-subtracted fp32
    softmax. q/k/v (B, S, H, D); terms as from `relpos_terms`."""
    return xla_attention(q, k, v, bias=_expand_bias(rel_h_term, rel_w_term),
                         scale=1.0 / math.sqrt(q.shape[-1]))


def grouped_window_attention_relpos(q, k, v, rel_h_term, rel_w_term,
                                    hw: Tuple[int, int]):
    """K2: rel-pos attention over a full (gh, gw) grid, (B, S, H, D) out.

    CPU tensors take `grouped_window_attention_relpos_torch`; CUDA tensors
    launch `csrc/sam_global_attention.cu` (online softmax over key tiles,
    bias rebuilt in the kernel)."""
    gh, gw = hw
    b, s, h, d = q.shape
    if s != gh * gw or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"grouped_window_attention_relpos: q/k/v "
                         f"{q.shape}/{k.shape}/{v.shape} do not match grid "
                         f"{hw}")
    if (rel_h_term.shape != (b, h, s, gh)
            or rel_w_term.shape != (b, h, s, gw)):
        raise ValueError(f"grouped_window_attention_relpos: rel terms "
                         f"{tuple(rel_h_term.shape)}, "
                         f"{tuple(rel_w_term.shape)}")
    if _kernels.on_cpu(q, k, v, rel_h_term, rel_w_term):
        return grouped_window_attention_relpos_torch(q, k, v, rel_h_term,
                                                     rel_w_term, hw)
    dt = _kernels.check_cuda_inputs(
        "grouped_window_attention_relpos",
        (q, k, v, rel_h_term, rel_w_term), d, b * h)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS["sam_global_attention"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h_term.data_ptr(),
            rel_w_term.data_ptr(), out.data_ptr(), b, s, h, d, gh, gw,
            1.0 / math.sqrt(d), dt, _kernels.stream_ptr(q))
    return out


class _GlobalRelpos(torch.autograd.Function):
    """`_grouped_with_vjp` (`sam_attention.py:946-973`): forward K2 (rel
    terms + kernel), saving q, k, v and the tables; backward K9 through
    `ops.sam_attention_bwd.relpos_vjp`, which recomputes the forward with
    its LSE."""

    @staticmethod
    def forward(ctx, q, k, v, rel_pos_h, rel_pos_w, hw):
        ctx.save_for_backward(q, k, v, rel_pos_h, rel_pos_w)
        ctx.hw = hw
        rh, rw = relpos_terms(q, rel_pos_h, rel_pos_w, hw)
        return grouped_window_attention_relpos(q, k, v, rh.contiguous(),
                                               rw.contiguous(), hw)

    @staticmethod
    def backward(ctx, g):
        from .sam_attention_bwd import relpos_vjp
        q, k, v, rel_pos_h, rel_pos_w = ctx.saved_tensors
        grads = relpos_vjp(q, k, v, rel_pos_h, rel_pos_w, ctx.hw, g,
                           ctx.needs_input_grad[3:5])
        return (*grads, None)


def sam_attention_with_relpos(q, k, v, rel_pos_h, rel_pos_w,
                              hw: Tuple[int, int]):
    """Full SAM attention: q unscaled (B, S, H, D) -> (B, S, H, D),
    differentiable (forward K2, backward K9).

    The JAX package takes its Pallas kernel on a TPU and the XLA path
    elsewhere; here the device of the tensors picks kernel or plain version
    inside the wrappers."""
    return _GlobalRelpos.apply(q, k, v, rel_pos_h, rel_pos_w, hw)


# ---------------------------------------------------------------------------
# K1: windowed blocks on the unsplit qkv
# ---------------------------------------------------------------------------

def _split_heads(qkv, num_heads: int):
    b, s, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    return (qkv[..., i * c:(i + 1) * c].reshape(b, s, num_heads, hd)
            for i in range(3))


def _v3_probs(qkv, rel_packed, hw: Tuple[int, int], num_heads: int):
    """K1's fp32 probabilities (B, H, S, S), 0 on all-underflow rows, and
    the v view of qkv."""
    gh, gw = hw
    b, s, _ = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    rel = rel_packed.reshape(b, s, num_heads, gh + gw).permute(0, 2, 1, 3)
    bias = _expand_bias(rel[..., :gh], rel[..., gh:])
    acc = _kernels.acc_dtype(qkv)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc))
              * (1.0 / math.sqrt(q.shape[-1])) + bias)
    underflow = (logits.amax(-1, keepdim=True) * LOG2E
                 < EXP2_SHIFT - 126.0)
    return torch.softmax(logits, dim=-1).masked_fill(underflow, 0.0), v


def grouped_window_attention_relpos_v3_torch(qkv, rel_packed,
                                             hw: Tuple[int, int],
                                             num_heads: int):
    """Plain version of K1: split views of qkv, materialized bias,
    max-subtracted fp32 softmax, and 0 for a row whose largest logit
    (log2 units) lies below EXP2_SHIFT - 126. qkv (nW, S, 3C) ->
    (nW, S, C)."""
    b, s, c3 = qkv.shape
    probs, v = _v3_probs(qkv, rel_packed, hw, num_heads)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(qkv.dtype), v)
    return out.reshape(b, s, c3 // 3)


def grouped_window_attention_relpos_v3_q8_torch(qkv, rel_packed,
                                                inv_scale,
                                                hw: Tuple[int, int],
                                                num_heads: int):
    """Plain version of K1q: K1's fp32 output, then
    clip(round(out * inv_scale), -127, 127) as int8 (nW, S, C)."""
    b, s, c3 = qkv.shape
    probs, v = _v3_probs(qkv, rel_packed, hw, num_heads)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    q = torch.clamp(torch.round(out * inv_scale.float()), -127, 127)
    return q.to(torch.int8).reshape(b, s, c3 // 3)


def grouped_window_attention_relpos_v3(qkv, rel_packed, hw: Tuple[int, int],
                                       num_heads: int, inv_scale=None):
    """K1: qkv (nW, S, 3*H*D) fused projection output, rel_packed as from
    `relpos_terms_raw` on its q third -> (nW, S, H*D) in qkv's dtype; K1q
    with `inv_scale` ((1,) fp32, 1 / act_scale): the same attention
    quantized to int8 by the static-scale epilogue.

    CPU tensors take the plain twins; CUDA tensors launch
    `csrc/sam_window_attention.cu`, which reads q, k and v at lane offsets
    of the unsplit qkv. All return 0 for an all-underflow row (see
    EXP2_SHIFT)."""
    gh, gw = hw
    b, s, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    if s != gh * gw or c3 != 3 * num_heads * hd:
        raise ValueError(f"grouped_window_attention_relpos_v3: qkv "
                         f"{tuple(qkv.shape)} does not match window {hw} "
                         f"and {num_heads} heads")
    if rel_packed.shape != (b, s, num_heads * (gh + gw)):
        raise ValueError(f"grouped_window_attention_relpos_v3: rel "
                         f"{tuple(rel_packed.shape)}")
    quantize = inv_scale is not None
    if quantize:
        inv_scale = inv_scale.reshape(1)
    if _kernels.on_cpu(qkv, rel_packed, *((inv_scale,) if quantize else ())):
        if quantize:
            return grouped_window_attention_relpos_v3_q8_torch(
                qkv, rel_packed, inv_scale, hw, num_heads)
        return grouped_window_attention_relpos_v3_torch(qkv, rel_packed, hw,
                                                        num_heads)
    dt = _kernels.check_cuda_inputs("grouped_window_attention_relpos_v3",
                                    (qkv, rel_packed), hd, b * num_heads)
    args = (b, s, num_heads, hd, gh, gw, 1.0 / math.sqrt(hd), dt,
            _kernels.stream_ptr(qkv))
    with torch.cuda.device(qkv.device):
        if quantize:
            _kernels.check_typed("grouped_window_attention_relpos_v3",
                                 [(inv_scale, torch.float32)])
            out = torch.empty((b, s, c), device=qkv.device,
                              dtype=torch.int8)
            _kernels.KERNELS["sam_window_attention_q8"](
                qkv.data_ptr(), rel_packed.data_ptr(), inv_scale.data_ptr(),
                out.data_ptr(), *args)
        else:
            out = torch.empty((b, s, c), device=qkv.device, dtype=qkv.dtype)
            _kernels.KERNELS["sam_window_attention"](
                qkv.data_ptr(), rel_packed.data_ptr(), out.data_ptr(), *args)
    return out


class _WindowFused(torch.autograd.Function):
    """`sam_window_attention_fused`'s custom VJP (`sam_attention.py:
    691-740`): forward K1 on the unsplit qkv, saving qkv and the tables
    (never the S x S probabilities); backward splits qkv into head layout
    and runs K9's forward and backward (`relpos_vjp`), as `_fused_qkv_bwd`
    does, then joins dq, dk, dv back into d(qkv)."""

    @staticmethod
    def forward(ctx, qkv, rel_pos_h, rel_pos_w, hw, num_heads):
        ctx.save_for_backward(qkv, rel_pos_h, rel_pos_w)
        ctx.hw, ctx.num_heads = hw, num_heads
        c = qkv.shape[-1] // 3
        rel = relpos_terms_raw(qkv[..., :c], rel_pos_h, rel_pos_w, hw,
                               num_heads)
        return grouped_window_attention_relpos_v3(qkv, rel, hw, num_heads)

    @staticmethod
    def backward(ctx, g):
        from .sam_attention_bwd import relpos_vjp
        qkv, rel_pos_h, rel_pos_w = ctx.saved_tensors
        b, s, c3 = qkv.shape
        nh = ctx.num_heads
        q, k, v = (t.reshape(b, s, nh, -1).contiguous()
                   for t in qkv.split(c3 // 3, dim=-1))
        dq, dk, dv, d_rh, d_rw = relpos_vjp(
            q, k, v, rel_pos_h, rel_pos_w, ctx.hw, g.reshape(q.shape),
            ctx.needs_input_grad[1:3])
        dqkv = torch.cat([t.reshape(b, s, c3 // 3) for t in (dq, dk, dv)],
                         dim=-1)
        return dqkv, d_rh, d_rw, None, None


def sam_window_attention_fused(qkv, rel_pos_h, rel_pos_w,
                               hw: Tuple[int, int], num_heads: int):
    """Windowed SAM attention on the unsplit qkv output (nW, S, 3C) ->
    (nW, S, C), differentiable: rel terms from the q third, then K1; the
    backward runs K9."""
    return _WindowFused.apply(qkv, rel_pos_h, rel_pos_w, hw, num_heads)


def sam_window_attention_fused_q8(qkv, rel_pos_h, rel_pos_w,
                                  hw: Tuple[int, int], num_heads: int,
                                  act_scale):
    """`sam_window_attention_fused` emitting the proj's int8 input: K1q
    with inv = 1 / max(act_scale, 1e-12) in fp32 (`sam_attention.py:675`).
    Returns int8 (nW, S, C)."""
    c = qkv.shape[-1] // 3
    rel = relpos_terms_raw(qkv[..., :c], rel_pos_h, rel_pos_w, hw, num_heads)
    inv = 1.0 / act_scale.float().clamp_min(1e-12)
    return grouped_window_attention_relpos_v3(qkv, rel, hw, num_heads,
                                              inv_scale=inv)
