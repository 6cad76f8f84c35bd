"""Attention ops: the plain fp32-softmax path, the flash kernel (K10), the
CLIP kernel (K3), the raw-layout causal prefill kernel (K5), and the
dispatching entry point.

Counterpart of `grove_tpu/ops/attention.py`. All shapes are
(batch, seq, heads, head_dim); softmax runs in fp32 whatever the input
dtype.

* `xla_attention` is the plain version (the name keeps the JAX package's):
  materialized fp32 logits, optional bias and mask. LLaMA prefill and decode
  over the bf16 cache use it directly, as the JAX package does.
* K3 and K10 each have two CUDA entries: bf16 at head dim 64, 80 or 128
  runs the tensor-core body (`csrc/attention_tc.cuh`, wgmma), fp32 and the
  head dim 8 the SIMT body (`csrc/attention_core.cuh`); `_tc_takes`
  decides, for CUDA tensors only, here and for K2 and K4.
* `flash_attention` is K10, online-softmax attention of (B, Sq, H, D)
  queries over (B, Sk, H, D) keys, causal (top-left aligned, as the TPU
  kernel masks) or not, beside its plain twin `flash_attention_torch`; the
  non-causal case with a ragged key tail takes `xla_attention`, as in JAX
  (`attention.py:132-136`). `_flash_with_vjp` gives it the JAX package's
  backward (`attention.py:306-325`): a recompute through `xla_attention`.
* `grouped_plain_attention` is K3, non-causal self-attention over a ragged
  S (CLIP's 577), beside its plain twin `grouped_plain_attention_torch`;
  `grouped_plain_attention_trainable` gives it the JAX package's backward
  (`attention.py:424-442`): a recompute through `xla_attention`, in torch
  ops (XLA there). Only `train_clip_adapters=True` differentiates it.
* `prefill_attention_raw` is K5, causal self-attention with a per-sample
  left pad in the raw (B, S, H*D) projection layout (the int8-cache
  prefill), beside `prefill_attention_raw_torch`; like K3 and K10 it has a
  tensor-core entry (bf16 at head dim 64, 80 or 128) and a SIMT one;
  `prefill_attention_trainable` is its pure-causal form for the cache-free
  pass at a ragged S, with the recompute backward through causal
  `xla_attention` (`attention.py:276-303`), in torch ops.
* `multi_head_attention` takes the JAX package's `impl` ("auto",
  "grouped", "pallas", "xla") with its meaning as the private keyword
  `_impl`: "pallas" is K4 + K4b
  (`ops.flash_backward.flash_attention_trainable`) where `_block_for(S)`
  finds a block and Sq == Sk, else K10 with its recompute backward;
  "grouped" is K3; `attention_route` names the kernel each call runs. No
  caller of the port sets it, the training driver included: the other
  values exist for the tests. "auto" picks as the JAX package does on
  the TPU, with
  the two choices the port made for the card from its first slice: the
  route does not depend on the device, because each wrapper launches its
  kernel for CUDA tensors and runs its plain twin for CPU ones (the
  tensors' device takes the place of `default_backend() == "tpu"`), and
  the lane-width term `head_dim % 128 == 0` is dropped, because the CUDA
  kernels take head dims 8 to 128. `_block_for`, `_grouped_plain_ok` and
  `prefill_attention_ok` are the port's copies of the JAX rules (the last
  without its lane term), so the routes equal the JAX package's.
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
    Logits and softmax in fp32 (float64 for float64 inputs); P.V in the
    input dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dtype, acc = q.dtype, _kernels.acc_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if bias is not None:
        logits = logits + bias.to(acc)
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


def _tc_takes(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a CUDA call of K1, K1q, K2, K3, K4, K5, K9's forward, K10,
    K11, K12, K12q8 or K13 runs the tensor-core body
    (`csrc/attention_tc.cuh`, the `_tc` entries), and K9's and K4b's dq and
    dkv the tensor-core backward body (`csrc/attention_bwd_tc.cuh`): bf16 at
    head dim 64, 80 or 128 (`_kernels.TC_HEAD_DIMS`; K9's also needs its
    term tables aligned, `sam_attention_bwd._tables_aligned`). fp32, and the
    head dim 8, run the SIMT bodies (`csrc/attention_core.cuh`,
    `csrc/attention_bwd_core.cuh`). Two hand-written kernels chosen by dtype
    and shape; a `_tc` launch that fails raises like any other."""
    return dtype == torch.bfloat16 and head_dim in _kernels.TC_HEAD_DIMS


LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# The TPU K1 takes its softmax as exp2(logit - EXP2_SHIFT) in log2 units
# (grove_tpu/ops/sam_attention.py:29-39), so a row whose largest logit lies
# below EXP2_SHIFT - 126 underflows everywhere and comes out as 0. K1 and its
# plain twins keep that contract; the overflow of terms above
# EXP2_SHIFT + 127 on the TPU is a fault they do not copy.
EXP2_SHIFT = 32.0


def tc_attention_torch(q, k, v, *, scale: float, causal: bool = False,
                       bias=None, lse: bool = False,
                       zero_underflow: bool = False, out_inv=None,
                       pad=None):
    """The tensor-core body's arithmetic (`csrc/attention_tc.cuh`) in torch
    ops, step by step: keys in tiles of 64; per tile the fp32 scores of
    Q.K^T times scale * log2(e) (an fp32 product) after the product; with
    `bias` = (rel_h (B, H, Sq, gh), rel_w (B, H, Sq, gw), gw) the term
    (rel_h[key / gw] + rel_w[key % gw]) * log2(e) added in fp32; causal,
    keys past the row masked to -inf (top-left); with `pad` ((B,) ints,
    K5), keys below pad[b] masked too except each row's own key; an online
    softmax in fp32 on exp2 (running max, sum over the unrounded P); P
    rounded to bf16 before P.V with an fp32 sum; the output times
    1 / max(l, 1e-30), or 0 with `zero_underflow` on a row whose max m lies
    below EXP2_SHIFT - 126 (K1's contract). q (B, Sq, H, D), k and v (B, Sk, H, D) -> fp32 (B, Sq,
    H, D); with `out_inv` ((1,) fp32, K1q) int8 clip(rint(out * out_inv),
    -127, 127); with `lse`, also (m + log2(max(l, 1e-30))) * ln(2), (B, H,
    Sq). No path of the port calls it: it is the plain version with the
    kernel's rounding points, for int8 checks where one rounding of P
    flips outputs, and K5's (whose TPU kernel rounds P to bf16 where this
    body does)."""
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    b, h, sq, d = qf.shape
    sk = kf.shape[2]
    dev = qf.device
    f32 = torch.float32
    sl2 = torch.tensor(scale, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
    log2e = torch.tensor(LOG2E, dtype=f32, device=dev)
    rows = torch.arange(sq, device=dev)[:, None]
    m = torch.full((b, h, sq, 1), float("-inf"), device=dev)
    l = torch.zeros((b, h, sq, 1), device=dev)
    o = torch.zeros((b, h, sq, d), device=dev)
    for k0 in range(0, sk, 64):
        keys = torch.arange(k0, min(k0 + 64, sk), device=dev)
        s = (qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)) * sl2.to(dev)
        if bias is not None:
            rel_h, rel_w, gw = bias
            s = s + (rel_h.float()[..., keys // gw]
                     + rel_w.float()[..., keys % gw]) * log2e
        if causal:
            s = s.masked_fill(keys[None, :] > rows, float("-inf"))
        if pad is not None:
            inside = ((keys[None, None, None, :]
                       < pad.to(dev).long()[:, None, None, None])
                      & (keys[None, :] != rows))
            s = s.masked_fill(inside, float("-inf"))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(mx == float("-inf"), torch.zeros_like(mx), mx)
        corr = torch.exp2(m - base)
        p = torch.exp2(s - base)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + 64]
        m = mx
    safe = l.clamp_min(1e-30)
    inv = 1.0 / safe
    if zero_underflow:
        inv = inv.masked_fill(m < EXP2_SHIFT - 126.0, 0.0)
    out = o * inv
    if out_inv is not None:
        out = torch.clamp(torch.round(out * out_inv.float().to(dev)), -127,
                          127).to(torch.int8)
    out = out.permute(0, 2, 1, 3)
    if not lse:
        return out
    return out, ((m + torch.log2(safe)) * LN2)[..., 0]


def grouped_plain_attention(q, k, v, *, scale: Optional[float] = None):
    """K3: non-causal self-attention, (B, S, H, D) -> (B, S, H, D).

    CPU tensors take `grouped_plain_attention_torch`; CUDA tensors launch
    `csrc/grouped_plain_attention.cu`, its tensor-core entry where
    `_tc_takes` holds and its SIMT entry otherwise; both mask the ragged
    edge in the kernel (no padded copies)."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"grouped_plain_attention: self-attention shapes "
                         f"differ: {q.shape}, {k.shape}, {v.shape}")
    if _kernels.on_cpu(q, k, v):
        return grouped_plain_attention_torch(q, k, v, scale=scale)
    name = ("grouped_plain_attention_tc" if _tc_takes(q.dtype, d)
            else "grouped_plain_attention")
    return _grouped_plain_launch(name, q, k, v, scale)


def _grouped_plain_launch(name: str, q, k, v, scale: float):
    """Launch the K3 entry `name` on CUDA tensors."""
    b, s, h, d = q.shape
    dt = _kernels.check_cuda_inputs(name, (q, k, v), d, b * h)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS[name](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, d, float(scale), dt, _kernels.stream_ptr(q))
    return out


def _xla_vjp(q, k, v, g, causal: bool, scale: float):
    """Gradients of `xla_attention` at (q, k, v) for the cotangent g: the
    recompute backward of K3 and K5, torch ops for the JAX package's XLA
    `jax.vjp`."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = xla_attention(q, k, v, causal=causal, scale=scale)
        return torch.autograd.grad(out, (q, k, v), g)


class _GroupedPlain(torch.autograd.Function):
    """`_grouped_plain_with_vjp` (`attention.py:424-442`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return grouped_plain_attention(q, k, v, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_xla_vjp(q, k, v, g, False, ctx.scale), None)


def grouped_plain_attention_trainable(q, k, v, *,
                                      scale: Optional[float] = None):
    """K3 with the recompute backward through `xla_attention`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _GroupedPlain.apply(q, k, v, scale)


# ---------------------------------------------------------------------------
# K10: flash attention over ragged and cross lengths
# ---------------------------------------------------------------------------

DEFAULT_BLOCK_Q = 512    # grove_tpu/ops/attention.py:61-62
DEFAULT_BLOCK_K = 512


def _check_flash(q, k, v) -> None:
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or (q.shape[0], q.shape[2], q.shape[3])
            != (k.shape[0], k.shape[2], k.shape[3]) or k.shape[1] < 1):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not "
                         "(B, Sq, H, D) and (B, Sk, H, D)")


def _flash_takes_kernel(sq: int, sk: int, causal: bool, block_k: int) -> bool:
    """Whether `flash_attention` runs the kernel at these lengths, as the
    JAX wrapper decides (`attention.py:124-136`): it pads the keys to its
    block, min(block_k, max(Sk, 16)), and a non-causal call with a key pad
    takes `xla_attention` instead (False). A causal right pad lies in the
    future of every row below Sk, but rows past Sk (Sq > Sk) see the zero
    keys, which join their softmax: JAX's output then depends on its
    padding, and this raises ValueError rather than copy it."""
    block = min(block_k, max(sk, 16))
    if not (-sk) % block:
        return True
    if not causal:
        return False
    if sq > sk:
        raise ValueError(
            f"flash_attention: causal with Sq = {sq} > Sk = {sk} and Sk no "
            f"multiple of the key block {block}: the JAX kernel lets its "
            "zero-padded keys into the softmax of rows past Sk, a result "
            "that depends on its padding")
    return True


def _flash_plain(q, k, v, causal: bool, scale: float):
    """K10's function with the TPU kernel's numerics (`attention.py:66-104`):
    q scaled in fp32 (float64 for float64 inputs) before the dot, masked
    logits set to NEG_INF (causal, top-left: row i sees keys 0..i), the
    softmax in fp32 with its sum floored at 1e-30, the output in q's dtype.
    One softmax over the row equals the kernel's online one up to
    rounding."""
    acc = _kernels.acc_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc) * scale, k.to(acc))
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p / denom, v.to(acc))
    return out.to(q.dtype)


def flash_attention_torch(q, k, v, *, causal: bool = False,
                          scale: Optional[float] = None,
                          block_q: int = DEFAULT_BLOCK_Q,
                          block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Plain version of `flash_attention`, the same contract: the plain
    twin of the kernel where it would run, `xla_attention` where JAX's
    wrapper takes it, the same ValueError. `block_q` changes nothing (the
    TPU wrapper drops its padded rows) and is kept for the signature."""
    del block_q
    _check_flash(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _flash_takes_kernel(q.shape[1], k.shape[1], causal, block_k):
        return xla_attention(q, k, v, scale=scale)
    return _flash_plain(q, k, v, causal, scale)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """K10: q (B, Sq, H, D) over k, v (B, Sk, H, D) -> (B, Sq, H, D).

    The JAX contract (`attention.py:109-172`): causal is top-left aligned
    (row i sees keys 0..i for any Sk - Sq; `xla_attention` aligns bottom
    right instead); a non-causal call whose keys would need a pad takes
    `xla_attention`; a causal call with Sq > Sk and a key pad raises
    ValueError (`_flash_takes_kernel`). CPU tensors take the plain twin;
    CUDA tensors launch `csrc/flash_attention.cu`, its tensor-core entry
    where `_tc_takes` holds and its SIMT entry otherwise; both read q, k
    and v in place and mask the ragged key tail themselves (no padded
    copies, no head fold)."""
    del block_q
    _check_flash(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _flash_takes_kernel(q.shape[1], k.shape[1], causal, block_k):
        return xla_attention(q, k, v, scale=scale)
    if _kernels.on_cpu(q, k, v):
        return _flash_plain(q, k, v, causal, scale)
    name = ("flash_attention_tc" if _tc_takes(q.dtype, q.shape[-1])
            else "flash_attention")
    return _flash_launch(name, q, k, v, causal, scale)


def _flash_launch(name: str, q, k, v, causal: bool, scale: float):
    """Launch the K10 entry `name` on CUDA tensors."""
    b, sq, h, d = q.shape
    dt = _kernels.check_cuda_inputs(name, (q, k, v), d, b * h)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS[name](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], h, d, int(bool(causal)), float(scale), dt,
            _kernels.stream_ptr(q))
    return out


class _FlashWithVjp(torch.autograd.Function):
    """`_flash_with_vjp` (`attention.py:306-325`): K10 forward, the
    backward a recompute through `xla_attention`, in torch ops."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*_xla_vjp(q, k, v, g, ctx.causal, ctx.scale), None, None)


def _flash_with_vjp(q, k, v, causal: bool, scale: Optional[float] = None):
    """Differentiable K10. Raises ValueError for causal Sq != Sk: the
    forward's mask is top-left aligned and the recompute backward's
    (`xla_attention`) bottom-right, so JAX's custom VJP there is not the
    derivative of its forward."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"_flash_with_vjp: causal with Sq = {q.shape[1]} "
                         f"!= Sk = {k.shape[1]}: the forward masks top-left, "
                         "the recompute backward bottom-right")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashWithVjp.apply(q, k, v, causal, scale)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _block_for(s: int) -> Optional[int]:
    """The largest flash block dividing S (`attention.py:328-332`)."""
    for b in (512, 256, 128, 64):
        if s % b == 0:
            return b
    return None


def _grouped_plain_ok(sq: int, sk: int, d: int) -> bool:
    """K3's eligibility (`attention.py:445-451`): self-attention with
    D % 8 == 0 and an (S, S) tile within the TPU kernel's VMEM budget,
    kept so that "auto" routes as the JAX package does."""
    s_pad = sq + (-sq) % 8
    return (sk == sq and d % 8 == 0
            and 12 * s_pad * s_pad + 8 * 2 * s_pad * d <= 12 * 2 ** 20)


def prefill_attention_ok(q_shape, num_heads: int) -> bool:
    """K5's eligibility for a (B, S, H*D) projection (`attention.py:
    267-273`) without the lane term `head_dim % 128 == 0` (the CUDA kernel
    takes head dims 8 to 128): MHA layout, S % 8 == 0, 128 <= S <= 1100."""
    _, s, c = q_shape
    hd = c // num_heads
    return c == num_heads * hd and s % 8 == 0 and 128 <= s <= 1100


IMPLS = ("auto", "grouped", "pallas", "xla")


def attention_route(sq: int, sk: int, d: int, causal: bool, simple: bool,
                    impl: str = "auto") -> str:
    """The kernel `multi_head_attention` runs, by its launch-count name:
    "grouped_plain_attention" (K3), "flash_forward_lse" (K4, K4b behind it),
    "flash_attention" (K10) or "xla" (the plain path). `impl` as JAX's
    (`attention.py:454-484`): "pallas" is K4 where `_block_for(Sq)` finds a
    block and Sq == Sk, else K10; "grouped" is K3; "auto" is JAX's pick on
    the TPU (`:460-471`) without the lane term: K3 for non-causal
    self-attention at S >= 128 that `_grouped_plain_ok` takes, else
    "pallas" at S >= 128, else "xla"; "xla" whenever there is a bias or a
    mask (`simple` false)."""
    if impl not in IMPLS:
        raise ValueError(f"multi_head_attention: impl {impl!r} not in "
                         f"{IMPLS}")
    if impl == "auto":
        if simple and not causal and sq >= 128 and _grouped_plain_ok(sq, sk,
                                                                     d):
            impl = "grouped"
        else:
            impl = "pallas" if simple and sq >= 128 else "xla"
    if impl == "xla":
        return "xla"
    if impl == "grouped":
        return "grouped_plain_attention"
    if _block_for(sq) is not None and sq == sk:
        return "flash_forward_lse"
    return "flash_attention"


def multi_head_attention(q, k, v, *, causal: bool = False,
                         bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None,
                         _impl: str = "auto") -> torch.Tensor:
    """Dispatching attention entry point (`attention.py:454-484`). Shapes
    (B, S, H, D). Runs the route `attention_route` names: K4 forward with
    the K4b backward, K10 or K3 with the recompute backward, or
    `xla_attention`. The port's callers leave the private `_impl` (JAX's
    `impl`) at "auto"; the other values are JAX's, for the tests. A bias or
    mask with a kernel impl raises ValueError (the kernels take neither)."""
    simple = bias is None and mask is None
    route = attention_route(q.shape[1], k.shape[1], q.shape[-1], causal,
                            simple, _impl)
    if route == "xla":
        return xla_attention(q, k, v, causal=causal, bias=bias, mask=mask,
                             scale=scale)
    if not simple:
        raise ValueError(f"multi_head_attention: impl {_impl!r} takes no "
                         "bias or mask")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if route == "grouped_plain_attention":
        return grouped_plain_attention_trainable(q, k, v, scale=scale)
    if route == "flash_forward_lse":
        from .flash_backward import flash_attention_trainable
        return flash_attention_trainable(q, k, v, causal, scale)
    return _flash_with_vjp(q, k, v, causal, scale)


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
    acc = _kernels.acc_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.to(acc), kh.to(acc)) * scale
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    pad = pad_lens.long()[:, None, None, None]
    valid = (kpos <= qpos) & ((kpos >= pad) | (kpos == qpos))
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(acc), vh.to(acc))
    out = out / denom.permute(0, 2, 1, 3)
    return out.to(q.dtype).reshape(b, s, c)


def prefill_attention_raw(q, k, v, pad_lens, num_heads: int, scale: float):
    """K5: causal self-attention over fresh q/k/v in the raw (B, S, H*D)
    layout; pad_lens (B,) counts each sample's leading masked key slots
    (0 = pure causal). Returns (B, S, H*D).

    CPU tensors take `prefill_attention_raw_torch`; CUDA tensors launch
    `csrc/prefill_attention.cu`, which reads the heads in place: its
    tensor-core entry where `_tc_takes` holds (every bf16 prefill of
    LLaMA-7B), its SIMT entry otherwise."""
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
    name = ("prefill_attention_tc" if _tc_takes(q.dtype, c // num_heads)
            else "prefill_attention")
    return _prefill_launch(name, q, k, v, pad_lens, num_heads, scale)


def _prefill_launch(name: str, q, k, v, pad_lens, num_heads: int,
                    scale: float):
    """Launch the K5 entry `name` on CUDA tensors."""
    b, s, c = q.shape
    hd = c // num_heads
    dt = _kernels.check_cuda_inputs(name, (q, k, v), hd, b * num_heads)
    pad = pad_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _kernels.KERNELS[name](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            out.data_ptr(), b, s, num_heads, hd, float(scale), dt,
            _kernels.stream_ptr(q))
    return out


class _PrefillTrainable(torch.autograd.Function):
    """`prefill_attention_trainable` (`attention.py:276-303`)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        pad = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
        return prefill_attention_raw(q, k, v, pad, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        b, s, c = q.shape
        heads = [t.reshape(b, s, ctx.num_heads, c // ctx.num_heads)
                 for t in (q, k, v, g)]
        grads = _xla_vjp(*heads, True, ctx.scale)
        return (*(t.reshape(b, s, c) for t in grads), None, None)


def prefill_attention_trainable(q, k, v, num_heads: int, scale: float):
    """K5 with no pad, for the cache-free pass at an S that is not a
    multiple of 64, with the recompute backward through causal
    `xla_attention`. q/k/v (B, S, H*D) -> (B, S, H*D)."""
    return _PrefillTrainable.apply(q, k, v, num_heads, scale)
