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

The JAX package's other public SAM attention ops, which no model path
dispatches, have their kernels too:

* K12 `grouped_window_attention_relpos_v2(_q8)`: K1 on split raw q/k/v;
  `sam_window_attention_raw` (backward K9) and `sam_window_attention_raw_q8`;
* K13 `folded_window_attention_relpos(_v2)`: the TPU's bias-folded
  experiments, head and raw layout;
* K11 `flash_attention_relpos`: the streamed flash form, reached through
  `_fused_relpos_attention` / `_fused_with_vjp` (a torch-ops backward).

Each has a plain twin (`*_torch`) that materializes the bias. Wrappers pick
by device: CPU tensors take the plain version, CUDA tensors the kernel. In
bf16 at head dim 64, 80 or 128 (`ops.attention._tc_takes`) K1, K1q, K2,
K11, K12, K12q8 and K13 launch their tensor-core entries, whose plain versions
with the body's rounding points are the `*_tc_torch` functions; so does
K12q8.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .. import _kernels
from .attention import (EXP2_SHIFT, LOG2E, _tc_takes, tc_attention_torch,
                        xla_attention)
from .sam_encoder_tables import gather_rel_tables


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


def _check_grid(name: str, q, k, v, rel_h_term, rel_w_term,
                hw: Tuple[int, int], heads: int, head_dim: int) -> None:
    """Raise ValueError unless q/k/v ((B, S, H, D), or raw (B, S, H*D))
    cover the (gh, gw) grid and the term tables are (B, H, S, gh/gw)."""
    gh, gw = hw
    b, s = q.shape[:2]
    if (s != gh * gw or k.shape != q.shape or v.shape != q.shape
            or q[0, 0].numel() != heads * head_dim):
        raise ValueError(f"{name}: q/k/v {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match grid {hw}")
    if (rel_h_term.shape != (b, heads, s, gh)
            or rel_w_term.shape != (b, heads, s, gw)):
        raise ValueError(f"{name}: rel terms {tuple(rel_h_term.shape)}, "
                         f"{tuple(rel_w_term.shape)}")


def _launch_grid(kernel: str, name: str, q, k, v, rel_h_term, rel_w_term,
                 hw: Tuple[int, int], heads: int, head_dim: int):
    """Launch a grid entry of K2, K11 or K13, on either body: q/k/v and out
    with rows of H*D (head h at lane offset h*D), (B, H, S, g) terms."""
    gh, gw = hw
    b, s = q.shape[:2]
    dt = _kernels.check_cuda_inputs(name, (q, k, v, rel_h_term, rel_w_term),
                                    head_dim, b * heads)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS[kernel](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h_term.data_ptr(),
            rel_w_term.data_ptr(), out.data_ptr(), b, s, heads, head_dim, gh,
            gw, 1.0 / math.sqrt(head_dim), dt, _kernels.stream_ptr(q))
    return out


def grouped_window_attention_relpos(q, k, v, rel_h_term, rel_w_term,
                                    hw: Tuple[int, int]):
    """K2: rel-pos attention over a full (gh, gw) grid, (B, S, H, D) out.

    CPU tensors take `grouped_window_attention_relpos_torch`; CUDA tensors
    launch `csrc/sam_global_attention.cu` (online softmax over key tiles,
    bias rebuilt in the kernel), its tensor-core entry where
    `ops.attention._tc_takes` holds (bf16 at D 64, 80, 128: SAM's global
    blocks in bf16 and under W8A8) and its SIMT entry otherwise."""
    name = "grouped_window_attention_relpos"
    _, _, h, d = q.shape
    _check_grid(name, q, k, v, rel_h_term, rel_w_term, hw, h, d)
    if _kernels.on_cpu(q, k, v, rel_h_term, rel_w_term):
        return grouped_window_attention_relpos_torch(q, k, v, rel_h_term,
                                                     rel_w_term, hw)
    kernel = ("sam_global_attention_tc" if _tc_takes(q.dtype, d)
              else "sam_global_attention")
    return _launch_grid(kernel, name, q, k, v, rel_h_term, rel_w_term, hw,
                        h, d)


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


def _window_attention_torch(q, k, v, rel_packed, hw: Tuple[int, int],
                            num_heads: int, inv_scale=None):
    """K1's and K12's plain math on (B, S, H, D) views: materialized bias,
    max-subtracted fp32 softmax, 0 for a row whose largest logit (log2
    units) lies below EXP2_SHIFT - 126, then P.V in the input dtype ->
    (B, S, H*D); with `inv_scale`, P.V in fp32 quantized to int8 as
    clip(round(out * inv_scale), -127, 127)."""
    gh, gw = hw
    b, s = q.shape[:2]
    rel = rel_packed.reshape(b, s, num_heads, gh + gw).permute(0, 2, 1, 3)
    bias = _expand_bias(rel[..., :gh], rel[..., gh:])
    acc = _kernels.acc_dtype(q)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc))
              * (1.0 / math.sqrt(q.shape[-1])) + bias)
    underflow = (logits.amax(-1, keepdim=True) * LOG2E
                 < EXP2_SHIFT - 126.0)
    probs = torch.softmax(logits, dim=-1).masked_fill(underflow, 0.0)
    if inv_scale is None:
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
        return out.reshape(b, s, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    quant = torch.clamp(torch.round(out * inv_scale.float()), -127, 127)
    return quant.to(torch.int8).reshape(b, s, -1)


def grouped_window_attention_relpos_v3_torch(qkv, rel_packed,
                                             hw: Tuple[int, int],
                                             num_heads: int):
    """Plain version of K1: split views of qkv, materialized bias,
    max-subtracted fp32 softmax, and 0 for a row whose largest logit
    (log2 units) lies below EXP2_SHIFT - 126. qkv (nW, S, 3C) ->
    (nW, S, C)."""
    return _window_attention_torch(*_split_heads(qkv, num_heads), rel_packed,
                                   hw, num_heads)


def grouped_window_attention_relpos_v3_q8_torch(qkv, rel_packed,
                                                inv_scale,
                                                hw: Tuple[int, int],
                                                num_heads: int):
    """Plain version of K1q: K1's fp32 output, then
    clip(round(out * inv_scale), -127, 127) as int8 (nW, S, C)."""
    return _window_attention_torch(*_split_heads(qkv, num_heads), rel_packed,
                                   hw, num_heads, inv_scale)


def _window_attention_tc_torch(q, k, v, rel_packed, hw: Tuple[int, int],
                               num_heads: int, inv_scale=None):
    """K1's, K1q's, K12's and K12q8's arithmetic on the tensor-core body, on
    (B, S, H, D) views (`ops.attention.tc_attention_torch`: 64-key tiles, P
    rounded to bf16 before P.V, the sum over the fp32 P, the output times
    1 / l), the all-underflow rows as zeros, then q's dtype or, with
    `inv_scale`, the int8 epilogue clip(rint(out * inv_scale), -127, 127)
    -> (B, S, H*D)."""
    gh, gw = hw
    b, s = q.shape[:2]
    rel = rel_packed.reshape(b, s, num_heads, gh + gw).permute(0, 2, 1, 3)
    out = tc_attention_torch(
        q, k, v, scale=1.0 / math.sqrt(q.shape[-1]),
        bias=(rel[..., :gh], rel[..., gh:], gw), zero_underflow=True,
        out_inv=None if inv_scale is None else inv_scale.reshape(1))
    return out.to(q.dtype if inv_scale is None else torch.int8).reshape(
        b, s, -1)


def grouped_window_attention_relpos_v3_tc_torch(qkv, rel_packed,
                                                hw: Tuple[int, int],
                                                num_heads: int,
                                                inv_scale=None):
    """K1 and K1q with the tensor-core body's rounding points
    (`_window_attention_tc_torch` on the split views of qkv) -> (nW, S, C)
    in qkv's dtype, or int8 with `inv_scale`. The plain version that
    `chip_smoke.py` holds the `_tc` entries' int8 output to; no model path
    calls it."""
    return _window_attention_tc_torch(*_split_heads(qkv, num_heads),
                                      rel_packed, hw, num_heads, inv_scale)


def _check_v3(qkv, rel_packed, hw: Tuple[int, int], num_heads: int) -> int:
    """Raise ValueError unless qkv (nW, S, 3C) and the packed table fit the
    window and the heads; return the head dim."""
    gh, gw = hw
    b, s, c3 = qkv.shape
    hd = c3 // 3 // num_heads
    if s != gh * gw or c3 != 3 * num_heads * hd:
        raise ValueError(f"grouped_window_attention_relpos_v3: qkv "
                         f"{tuple(qkv.shape)} does not match window {hw} "
                         f"and {num_heads} heads")
    if rel_packed.shape != (b, s, num_heads * (gh + gw)):
        raise ValueError(f"grouped_window_attention_relpos_v3: rel "
                         f"{tuple(rel_packed.shape)}")
    return hd


def _window_launch(name: str, qkv, rel_packed, hw: Tuple[int, int],
                   num_heads: int, inv_scale=None):
    """Launch the K1 entry `name` on CUDA tensors (K1q's, an int8 output,
    with `inv_scale`, a (1,) fp32 tensor)."""
    gh, gw = hw
    b, s, c3 = qkv.shape
    hd = _check_v3(qkv, rel_packed, hw, num_heads)
    dt = _kernels.check_cuda_inputs(name, (qkv, rel_packed), hd,
                                    b * num_heads)
    args = (b, s, num_heads, hd, gh, gw, 1.0 / math.sqrt(hd), dt,
            _kernels.stream_ptr(qkv))
    with torch.cuda.device(qkv.device):
        if inv_scale is not None:
            _kernels.check_typed(name, [(inv_scale, torch.float32)])
            out = torch.empty((b, s, c3 // 3), device=qkv.device,
                              dtype=torch.int8)
            _kernels.KERNELS[name](
                qkv.data_ptr(), rel_packed.data_ptr(), inv_scale.data_ptr(),
                out.data_ptr(), *args)
        else:
            out = torch.empty((b, s, c3 // 3), device=qkv.device,
                              dtype=qkv.dtype)
            _kernels.KERNELS[name](
                qkv.data_ptr(), rel_packed.data_ptr(), out.data_ptr(), *args)
    return out


def grouped_window_attention_relpos_v3(qkv, rel_packed, hw: Tuple[int, int],
                                       num_heads: int, inv_scale=None):
    """K1: qkv (nW, S, 3*H*D) fused projection output, rel_packed as from
    `relpos_terms_raw` on its q third -> (nW, S, H*D) in qkv's dtype; K1q
    with `inv_scale` ((1,) fp32, 1 / act_scale): the same attention
    quantized to int8 by the static-scale epilogue.

    CPU tensors take the plain twins; CUDA tensors launch
    `csrc/sam_window_attention.cu`, which reads q, k and v at lane offsets
    of the unsplit qkv: its tensor-core entries where
    `ops.attention._tc_takes` holds (bf16 at D 64, 80, 128: SAM's windowed
    blocks in bf16 and under W8A8) and its SIMT entries otherwise. All
    return 0 for an all-underflow row (see EXP2_SHIFT)."""
    hd = _check_v3(qkv, rel_packed, hw, num_heads)
    quantize = inv_scale is not None
    if quantize:
        inv_scale = inv_scale.reshape(1)
    if _kernels.on_cpu(qkv, rel_packed, *((inv_scale,) if quantize else ())):
        if quantize:
            return grouped_window_attention_relpos_v3_q8_torch(
                qkv, rel_packed, inv_scale, hw, num_heads)
        return grouped_window_attention_relpos_v3_torch(qkv, rel_packed, hw,
                                                        num_heads)
    name = "sam_window_attention_q8" if quantize else "sam_window_attention"
    if _tc_takes(qkv.dtype, hd):
        name += "_tc"
    return _window_launch(name, qkv, rel_packed, hw, num_heads, inv_scale)


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


# ---------------------------------------------------------------------------
# K12: windowed blocks on split raw q / k / v (the JAX package's v2)
# ---------------------------------------------------------------------------

def grouped_window_attention_relpos_v2_torch(q, k, v, rel_packed,
                                             hw: Tuple[int, int],
                                             num_heads: int):
    """Plain version of K12: K1's function on three raw (nW, S, C)
    projections -> (nW, S, C)."""
    b, s, c = q.shape
    return _window_attention_torch(
        *(t.reshape(b, s, num_heads, c // num_heads) for t in (q, k, v)),
        rel_packed, hw, num_heads)


def grouped_window_attention_relpos_v2_tc_torch(q, k, v, rel_packed,
                                                hw: Tuple[int, int],
                                                num_heads: int):
    """K12 with the tensor-core body's rounding points: K1's
    (`_window_attention_tc_torch`) on three raw (nW, S, C) projections ->
    (nW, S, C) in q's dtype. The plain version that `chip_smoke.py` holds
    K12's `_tc` entry to; no model path calls it."""
    b, s, c = q.shape
    return _window_attention_tc_torch(
        *(t.reshape(b, s, num_heads, c // num_heads) for t in (q, k, v)),
        rel_packed, hw, num_heads)


def grouped_window_attention_relpos_v2_q8_torch(q, k, v, rel_packed,
                                                inv_scale,
                                                hw: Tuple[int, int],
                                                num_heads: int):
    """Plain version of K12q8: K12's fp32 output, then
    clip(round(out * inv_scale), -127, 127) as int8 (nW, S, C)."""
    b, s, c = q.shape
    return _window_attention_torch(
        *(t.reshape(b, s, num_heads, c // num_heads) for t in (q, k, v)),
        rel_packed, hw, num_heads, inv_scale.reshape(1))


def grouped_window_attention_relpos_v2_q8_tc_torch(q, k, v, rel_packed,
                                                   inv_scale,
                                                   hw: Tuple[int, int],
                                                   num_heads: int):
    """K12q8 with the tensor-core body's rounding points: K1q's
    (`_window_attention_tc_torch` with `inv_scale`: P rounded to bf16
    before P.V, the sum over the fp32 P, the all-underflow rows 0, then
    clip(rint(out * inv_scale), -127, 127)) on three raw (nW, S, C)
    projections -> int8 (nW, S, C). The plain version that `chip_smoke.py`
    holds K12q8's `_tc` entry to; no model path calls it."""
    b, s, c = q.shape
    return _window_attention_tc_torch(
        *(t.reshape(b, s, num_heads, c // num_heads) for t in (q, k, v)),
        rel_packed, hw, num_heads, inv_scale.reshape(1))


def _check_v2(q, k, v, rel_packed, hw: Tuple[int, int],
              num_heads: int) -> int:
    """Raise ValueError unless q, k, v (nW, S, C) and the packed table fit
    the window and the heads; return the head dim."""
    name = "grouped_window_attention_relpos_v2"
    gh, gw = hw
    b, s, c = q.shape
    hd = c // num_heads
    if (s != gh * gw or c != num_heads * hd or k.shape != q.shape
            or v.shape != q.shape):
        raise ValueError(f"{name}: q/k/v {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not match window {hw} and "
                         f"{num_heads} heads")
    if rel_packed.shape != (b, s, num_heads * (gh + gw)):
        raise ValueError(f"{name}: rel {tuple(rel_packed.shape)}")
    return hd


def _split_launch(name: str, q, k, v, rel_packed, hw: Tuple[int, int],
                  num_heads: int, inv_scale=None):
    """Launch the K12 entry `name` on CUDA tensors (K12q8's, an int8
    output, with `inv_scale`, a (1,) fp32 tensor)."""
    gh, gw = hw
    b, s, c = q.shape
    hd = _check_v2(q, k, v, rel_packed, hw, num_heads)
    dt = _kernels.check_cuda_inputs(name, (q, k, v, rel_packed), hd,
                                    b * num_heads)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_packed.data_ptr())
    args = (b, s, num_heads, hd, gh, gw, 1.0 / math.sqrt(hd), dt,
            _kernels.stream_ptr(q))
    with torch.cuda.device(q.device):
        if inv_scale is not None:
            _kernels.check_typed(name, [(inv_scale, torch.float32)])
            out = torch.empty((b, s, c), device=q.device, dtype=torch.int8)
            _kernels.KERNELS[name](*ptrs, inv_scale.data_ptr(),
                                   out.data_ptr(), *args)
        else:
            out = torch.empty_like(q)
            _kernels.KERNELS[name](*ptrs, out.data_ptr(), *args)
    return out


def _window_v2(q, k, v, rel_packed, hw: Tuple[int, int], num_heads: int,
               inv_scale=None):
    hd = _check_v2(q, k, v, rel_packed, hw, num_heads)
    quantize = inv_scale is not None
    if quantize:
        inv_scale = inv_scale.reshape(1)
    if _kernels.on_cpu(q, k, v, rel_packed,
                       *((inv_scale,) if quantize else ())):
        if quantize:
            return grouped_window_attention_relpos_v2_q8_torch(
                q, k, v, rel_packed, inv_scale, hw, num_heads)
        return grouped_window_attention_relpos_v2_torch(q, k, v, rel_packed,
                                                        hw, num_heads)
    name = "sam_window_attention_v2" + ("_q8" if quantize else "")
    if _tc_takes(q.dtype, hd):
        name += "_tc"
    return _split_launch(name, q, k, v, rel_packed, hw, num_heads, inv_scale)


def grouped_window_attention_relpos_v2(q, k, v, rel_packed,
                                       hw: Tuple[int, int], num_heads: int):
    """K12: q/k/v (nW, S, H*D) raw projection outputs, rel_packed as from
    `relpos_terms_raw` -> (nW, S, H*D) in q's dtype. K1's function and its
    all-underflow contract (see EXP2_SHIFT) on split inputs.

    CPU tensors take `grouped_window_attention_relpos_v2_torch`; CUDA
    tensors launch `csrc/sam_window_attention_v2.cu`: its tensor-core entry
    (K1's body) where `ops.attention._tc_takes` holds (bf16 at D 64, 80,
    128) and its SIMT entry otherwise."""
    return _window_v2(q, k, v, rel_packed, hw, num_heads)


def grouped_window_attention_relpos_v2_q8(q, k, v, rel_packed, inv_scale,
                                          hw: Tuple[int, int],
                                          num_heads: int):
    """K12q8: K12 with the int8 epilogue, `inv_scale` a (1,) fp32 tensor
    1 / act_scale -> int8 (nW, S, H*D), K1q's contract on split inputs.

    CPU tensors take `grouped_window_attention_relpos_v2_q8_torch`; CUDA
    tensors launch `csrc/sam_window_attention_v2.cu`: its tensor-core entry
    (K1q's body) where `ops.attention._tc_takes` holds (bf16 at D 64, 80,
    128) and its SIMT entry otherwise."""
    return _window_v2(q, k, v, rel_packed, hw, num_heads,
                      inv_scale.float())


class _WindowRaw(torch.autograd.Function):
    """`sam_window_attention_raw`'s custom VJP (`sam_attention.py:865-888`):
    forward K12 (rel terms + kernel), saving q, k, v and the tables;
    backward K9 in head layout (`relpos_vjp`), the gradients reshaped back
    to the raw layout."""

    @staticmethod
    def forward(ctx, q, k, v, rel_pos_h, rel_pos_w, hw, num_heads):
        ctx.save_for_backward(q, k, v, rel_pos_h, rel_pos_w)
        ctx.hw, ctx.num_heads = hw, num_heads
        rel = relpos_terms_raw(q, rel_pos_h, rel_pos_w, hw, num_heads)
        return grouped_window_attention_relpos_v2(q, k, v, rel, hw,
                                                  num_heads)

    @staticmethod
    def backward(ctx, g):
        from .sam_attention_bwd import relpos_vjp
        q, k, v, rel_pos_h, rel_pos_w = ctx.saved_tensors
        b, s, c = q.shape
        nh = ctx.num_heads
        qh, kh, vh = (t.reshape(b, s, nh, c // nh).contiguous()
                      for t in (q, k, v))
        dq, dk, dv, d_rh, d_rw = relpos_vjp(
            qh, kh, vh, rel_pos_h, rel_pos_w, ctx.hw,
            g.reshape(qh.shape).contiguous(), ctx.needs_input_grad[3:5])
        return (dq.reshape(b, s, c), dk.reshape(b, s, c),
                dv.reshape(b, s, c), d_rh, d_rw, None, None)


def sam_window_attention_raw(q, k, v, rel_pos_h, rel_pos_w,
                             hw: Tuple[int, int], num_heads: int):
    """Windowed SAM attention on the raw projection layout: q/k/v
    (nW, S, H*D) -> (nW, S, H*D), differentiable: rel terms from q, then
    K12; the backward runs K9."""
    return _WindowRaw.apply(q, k, v, rel_pos_h, rel_pos_w, hw, num_heads)


def sam_window_attention_raw_q8(q, k, v, rel_pos_h, rel_pos_w,
                                hw: Tuple[int, int], num_heads: int,
                                act_scale):
    """`sam_window_attention_raw` emitting int8: K12q8 with
    inv = 1 / max(act_scale, 1e-12) in fp32 (`sam_attention.py:661-672`).
    No backward, as in JAX."""
    rel = relpos_terms_raw(q, rel_pos_h, rel_pos_w, hw, num_heads)
    inv = 1.0 / act_scale.float().clamp_min(1e-12)
    return grouped_window_attention_relpos_v2_q8(q, k, v, rel, inv, hw,
                                                 num_heads)


# ---------------------------------------------------------------------------
# K13: the bias-folded experiments, head layout (v1) and raw layout (v2)
# ---------------------------------------------------------------------------

def folded_window_attention_relpos_tc_torch(q, k, v, rel_h_term,
                                            rel_w_term, hw: Tuple[int, int]):
    """K13 v1 with the tensor-core body's rounding points: K2's
    (`ops.attention.tc_attention_torch` with the bias) on the (B, S, H, D)
    q, k, v -> (B, S, H, D) in q's dtype. The plain version that
    `chip_smoke.py` holds K13 v1's `_tc` entry to; no model path calls
    it."""
    out = tc_attention_torch(q, k, v, scale=1.0 / math.sqrt(q.shape[-1]),
                             bias=(rel_h_term, rel_w_term, hw[1]))
    return out.to(q.dtype)


def folded_window_attention_relpos(q, k, v, rel_h_term, rel_w_term,
                                   hw: Tuple[int, int]):
    """K13 v1: q/k/v (B, S, H, D), rel terms (B, H, S, gh/gw) as from
    `relpos_terms` -> (B, S, H, D); the contract of
    `grouped_window_attention_relpos`: the TPU kernel's one-hot fold
    computes the decomposed rel-pos attention exactly, so its plain version
    is K2's. CUDA tensors launch `csrc/folded_window_attention.cu`: its
    tensor-core entry (K2's body) where `ops.attention._tc_takes` holds
    (bf16 at D 64, 80, 128) and its SIMT entry otherwise."""
    name = "folded_window_attention_relpos"
    _, _, h, d = q.shape
    _check_grid(name, q, k, v, rel_h_term, rel_w_term, hw, h, d)
    if _kernels.on_cpu(q, k, v, rel_h_term, rel_w_term):
        return grouped_window_attention_relpos_torch(q, k, v, rel_h_term,
                                                     rel_w_term, hw)
    kernel = ("folded_window_attention_tc" if _tc_takes(q.dtype, d)
              else "folded_window_attention")
    return _launch_grid(kernel, name, q, k, v, rel_h_term, rel_w_term, hw,
                        h, d)


def folded_window_attention_relpos_v2_torch(q, k, v, rel_h_term,
                                            rel_w_term, hw: Tuple[int, int],
                                            num_heads: int):
    """Plain version of K13 v2: K2's on the raw (B, S, H*D) layout."""
    b, s, c = q.shape
    out = grouped_window_attention_relpos_torch(
        *(t.reshape(b, s, num_heads, c // num_heads) for t in (q, k, v)),
        rel_h_term, rel_w_term, hw)
    return out.reshape(b, s, c)


def folded_window_attention_relpos_v2_tc_torch(q, k, v, rel_h_term,
                                               rel_w_term,
                                               hw: Tuple[int, int],
                                               num_heads: int):
    """K13 v2 with the tensor-core body's rounding points: K13 v1's
    (`folded_window_attention_relpos_tc_torch`) on the (B, S, H, D) views
    of the raw (B, S, H*D) q, k, v -> (B, S, H*D) in q's dtype. The plain
    version that `chip_smoke.py` holds K13 v2's `_tc` entry to; no model
    path calls it."""
    b, s, c = q.shape
    out = folded_window_attention_relpos_tc_torch(
        *(t.reshape(b, s, num_heads, c // num_heads) for t in (q, k, v)),
        rel_h_term, rel_w_term, hw)
    return out.reshape(b, s, c)


def folded_window_attention_relpos_v2(q, k, v, rel_h_term, rel_w_term,
                                      hw: Tuple[int, int], num_heads: int):
    """K13 v2: q/k/v raw (B, S, H*D), rel terms (B, H, S, gh/gw) ->
    (B, S, H*D). CPU tensors take `folded_window_attention_relpos_v2_torch`;
    CUDA tensors launch `csrc/folded_window_attention.cu`: its tensor-core
    entry (K2's body) where `ops.attention._tc_takes` holds (bf16 at D 64,
    80, 128) and its SIMT entry otherwise."""
    name = "folded_window_attention_relpos_v2"
    b, s, c = q.shape
    hd = c // num_heads
    _check_grid(name, q, k, v, rel_h_term, rel_w_term, hw, num_heads, hd)
    if _kernels.on_cpu(q, k, v, rel_h_term, rel_w_term):
        return folded_window_attention_relpos_v2_torch(
            q, k, v, rel_h_term, rel_w_term, hw, num_heads)
    kernel = ("folded_window_attention_v2_tc" if _tc_takes(q.dtype, hd)
              else "folded_window_attention_v2")
    return _launch_grid(kernel, name, q, k, v, rel_h_term, rel_w_term, hw,
                        num_heads, hd)


# ---------------------------------------------------------------------------
# K11: the streamed rel-pos flash attention (`flash_attention_relpos`)
# ---------------------------------------------------------------------------

def flash_attention_relpos(q, k, v, rel_h_term, rel_w_term,
                           hw: Tuple[int, int], block_q: int = 256,
                           block_k: int = 256):
    """K11: q/k/v (B, S, H, D), rel terms (B, H, S, gh/gw) -> (B, S, H, D),
    non-causal. The blocks are the TPU kernel's tiles: they must divide S
    and block_k must be a multiple of gw (JAX asserts it, `:120`; here a
    ValueError), and they do not change the result. Its plain version is
    K2's (the same function). CUDA tensors launch
    `csrc/streamed_relpos_attention.cu`: its tensor-core entry (K2's body)
    where `ops.attention._tc_takes` holds (bf16 at D 64, 80, 128) and its
    SIMT entry otherwise."""
    name = "flash_attention_relpos"
    _, s, h, d = q.shape
    gw = hw[1]
    block_q, block_k = min(block_q, s), min(block_k, s)
    if not (s % block_q == 0 and s % block_k == 0 and block_k % gw == 0):
        raise ValueError(f"{name}: blocks ({block_q}, {block_k}) must divide "
                         f"S = {s}, and block_k be a multiple of gw = {gw}")
    _check_grid(name, q, k, v, rel_h_term, rel_w_term, hw, h, d)
    if _kernels.on_cpu(q, k, v, rel_h_term, rel_w_term):
        return grouped_window_attention_relpos_torch(q, k, v, rel_h_term,
                                                     rel_w_term, hw)
    kernel = ("flash_attention_relpos_tc" if _tc_takes(q.dtype, d)
              else "flash_attention_relpos")
    return _launch_grid(kernel, name, q, k, v, rel_h_term, rel_w_term, hw,
                        h, d)


def _fused_relpos_attention(q, k, v, rel_pos_h, rel_pos_w,
                            hw: Tuple[int, int]):
    """Rel terms, then K11 with JAX's block choice (`:901-910`): the
    largest power-of-two multiple of gw up to min(S, 512) that divides S."""
    s, w = q.shape[1], hw[1]
    rh, rw = relpos_terms(q, rel_pos_h, rel_pos_w, hw)
    block_k = w
    while block_k * 2 <= min(s, 512) and s % (block_k * 2) == 0:
        block_k *= 2
    return flash_attention_relpos(q, k, v, rh.contiguous(), rw.contiguous(),
                                  hw, block_q=block_k, block_k=block_k)


class _FusedRelpos(torch.autograd.Function):
    """`_fused_with_vjp` (`sam_attention.py:913-943`): forward K11; the
    backward recomputes the plain rel-pos attention in torch ops one sample
    at a time (so the (H, S, S) buffers of the global shape never stack)
    and sums the tables' gradients over the samples."""

    @staticmethod
    def forward(ctx, q, k, v, rel_pos_h, rel_pos_w, hw):
        ctx.save_for_backward(q, k, v, rel_pos_h, rel_pos_w)
        ctx.hw = hw
        return _fused_relpos_attention(q, k, v, rel_pos_h, rel_pos_w, hw)

    @staticmethod
    def backward(ctx, g):
        q, k, v, rel_pos_h, rel_pos_w = ctx.saved_tensors
        grads = [torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v), torch.zeros_like(rel_pos_h),
                 torch.zeros_like(rel_pos_w)]
        with torch.enable_grad():
            for i in range(q.shape[0]):
                leaves = [t.detach().requires_grad_() for t in
                          (q[i:i + 1], k[i:i + 1], v[i:i + 1], rel_pos_h,
                           rel_pos_w)]
                rh, rw = relpos_terms(leaves[0], leaves[3], leaves[4],
                                      ctx.hw)
                out = grouped_window_attention_relpos_torch(
                    *leaves[:3], rh, rw, ctx.hw)
                got = torch.autograd.grad(out, leaves, g[i:i + 1])
                for j in range(3):
                    grads[j][i:i + 1] = got[j]
                grads[3] += got[3]
                grads[4] += got[4]
        return (*grads, None)


def _fused_with_vjp(q, k, v, rel_pos_h, rel_pos_w, hw: Tuple[int, int]):
    """Full rel-pos attention through K11, differentiable: q unscaled
    (B, S, H, D) -> (B, S, H, D)."""
    return _FusedRelpos.apply(q, k, v, rel_pos_h, rel_pos_w, hw)
