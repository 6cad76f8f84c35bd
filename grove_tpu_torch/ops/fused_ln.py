"""LayerNorm -> static int8 quantize, alone (K8a) or after a residual add
(K8b); [add +] RMSNorm -> dynamic per-token int8 (K8c).

Counterpart of `grove_tpu/ops/fused_ln.py:29-94` (`add_layernorm_quant`),
`:97-177` (`add_rmsnorm_quant_dyn`, K8c: its section at the end of this
module) and `:180-236` (`layernorm_quant`). For K8a and K8b the calibrated
activation scale folds into gamma and beta in fp32 OUTSIDE the kernel,
gs = gamma / act_scale and bs = beta / act_scale, so that

    q = clip(round((x - mu) * rsqrt(var + eps) * gs + bs), -127, 127)

with two-pass fp32 statistics (the mean, then the mean of d * d) and
round half to even. K8b first forms resid = a + b in a's dtype and returns
it beside q.

Dispatch, as in the JAX package: K8b takes the kernel route when
C % 128 == 0; K8a only when `use_kernel` (`cfg.quant_ln_kernel`) is set and
C % 128 == 0; otherwise both run the same folded chain in torch ops. On the
kernel route a CPU tensor takes the plain twin (`*_folded_torch`) and a
CUDA tensor launches `csrc/layernorm_quant.cu`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from .. import _kernels

MAX_C = 2048            # csrc/layernorm_quant.cu keeps a row in registers


def fold_scales(gamma, beta, act_scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gamma / act_scale, beta / act_scale) in fp32, contiguous."""
    s = act_scale.float()
    return ((gamma.float() / s).contiguous(),
            (beta.float() / s).contiguous())


def layernorm_quant_folded_torch(x, gs, bs, eps: float):
    """Plain twin of K8a: (..., C) float -> int8 of the same shape."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(-1, keepdim=True)
    y = d * torch.rsqrt(var + eps) * gs + bs
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def add_layernorm_quant_folded_torch(a, b, gs, bs, eps: float):
    """Plain twin of K8b: (resid = a + b in a's dtype, int8 of resid)."""
    resid = a + b.to(a.dtype)
    return resid, layernorm_quant_folded_torch(resid, gs, bs, eps)


def _check(name: str, x: torch.Tensor, gs, bs) -> int:
    c = x.shape[-1]
    if c % 128 or c > MAX_C:
        raise ValueError(f"{name}: C = {c} must be a multiple of 128 and at "
                         f"most {MAX_C}")
    dt = _kernels.dtype_code(name, x)
    _kernels.check_typed(name, [(x, x.dtype), (gs, torch.float32),
                                (bs, torch.float32)])
    if gs.shape != (c,) or bs.shape != (c,):
        raise ValueError(f"{name}: folded scales {tuple(gs.shape)}, "
                         f"{tuple(bs.shape)} for C = {c}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: input not 16-byte aligned")
    return dt


def layernorm_quant_folded(x, gs, bs, eps: float):
    """K8a on folded scales: x (..., C) fp32 or bf16 -> int8."""
    if _kernels.on_cpu(x, gs, bs):
        return layernorm_quant_folded_torch(x, gs, bs, eps)
    dt = _check("layernorm_quant", x, gs, bs)
    c = x.shape[-1]
    q = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    with torch.cuda.device(x.device):
        _kernels.KERNELS["layernorm_quant"](
            x.data_ptr(), gs.data_ptr(), bs.data_ptr(), q.data_ptr(),
            x.numel() // c, c, float(eps), dt, _kernels.stream_ptr(x))
    return q


def add_layernorm_quant_folded(a, b, gs, bs, eps: float):
    """K8b on folded scales: a, b (..., C) -> (resid in a's dtype, int8)."""
    b = b.to(a.dtype)
    if _kernels.on_cpu(a, b, gs, bs):
        return add_layernorm_quant_folded_torch(a, b, gs, bs, eps)
    dt = _check("add_layernorm_quant", a, gs, bs)
    _kernels.check_typed("add_layernorm_quant", [(b, a.dtype)])
    if b.shape != a.shape or b.data_ptr() % 16:
        raise ValueError(f"add_layernorm_quant: b {tuple(b.shape)} against "
                         f"a {tuple(a.shape)}, or b not 16-byte aligned")
    c = a.shape[-1]
    resid = torch.empty_like(a)
    q = torch.empty(a.shape, device=a.device, dtype=torch.int8)
    with torch.cuda.device(a.device):
        _kernels.KERNELS["add_layernorm_quant"](
            a.data_ptr(), b.data_ptr(), gs.data_ptr(), bs.data_ptr(),
            resid.data_ptr(), q.data_ptr(), a.numel() // c, c, float(eps),
            dt, _kernels.stream_ptr(a))
    return resid, q


def layernorm_quant(x, gamma, beta, act_scale, *, eps: float = 1e-6,
                    use_kernel: bool = False):
    """LayerNorm then static int8 quant: ln(x) ~= out * act_scale
    (`fused_ln.py:189-231`)."""
    gs, bs = fold_scales(gamma, beta, act_scale)
    if use_kernel and x.shape[-1] % 128 == 0:
        return layernorm_quant_folded(x.contiguous(), gs, bs, eps)
    return layernorm_quant_folded_torch(x, gs, bs, eps)


def add_layernorm_quant(a, b, gamma, beta, act_scale, *, eps: float = 1e-6):
    """Residual add + LayerNorm + static int8 quant: (resid = a + b in a's
    dtype, q) with ln(resid) ~= q * act_scale (`fused_ln.py:40-94`)."""
    gs, bs = fold_scales(gamma, beta, act_scale)
    if a.shape[-1] % 128 == 0:
        return add_layernorm_quant_folded(a.contiguous(), b.contiguous(),
                                          gs, bs, eps)
    return add_layernorm_quant_folded_torch(a, b, gs, bs, eps)


# ---------------------------------------------------------------------------
# K8c: [add +] RMSNorm -> dynamic per-token int8
# ---------------------------------------------------------------------------

# csrc/rmsnorm_quant.cu: a thread holds at most 32 elements of a row in
# registers (16 at C = 4096, its compile-time instantiation)
RMS_MAX_C = 8192
RMS_EXACT_C = 4096
RMS_MAX_SLOTS = 2
# CTAs an SM the register budget allows (the kernels' __launch_bounds__):
# the C = 4096 instantiation, any other C
RMS_BLOCKS = (3, 2)
_SMEM_BLOCK = 232448    # dynamic shared bytes one block can use on sm_90
_SMEM_SM = 233472       # shared bytes an SM holds
_SMEM_RESERVED = 1024   # the runtime's share a block
_SMEM_STATIC = 64       # the kernel's block reductions, 2 x 8 floats


class RmsPlan(NamedTuple):
    """One launch of K8c: CTA b takes rows b, b + ctas, ... through a ring
    of `slots` row slots (a row of a, and of b with the add)."""
    slots: int
    smem: int           # dynamic shared bytes a CTA: the ring, its barriers
    per_sm: int         # CTAs an SM: shared memory, then the register cap
    ctas: int


@functools.lru_cache(maxsize=None)
def _rms_plan(rows: int, c: int, sms: int, elem_bytes: int = 2,
              add: bool = True) -> RmsPlan:
    """The launch of K8c for `rows` rows of C elements of `elem_bytes`
    (4 fp32, 2 bf16), with or without the residual branch, on a card of
    `sms` SMs, as the C entries make it (`grove_rmsnorm_quant_plan` reports
    the library's): as many row slots as fit, up to RMS_MAX_SLOTS; as many
    CTAs an SM as shared memory holds, up to RMS_BLOCKS; never more CTAs
    than rows. Raises ValueError for C off a multiple of 128 or above
    RMS_MAX_C."""
    if rows <= 0 or c <= 0 or c % 128 or c > RMS_MAX_C:
        raise ValueError(f"add_rmsnorm_quant_dyn: C = {c} must be a "
                         f"multiple of 128 and at most {RMS_MAX_C}")
    slot = (2 if add else 1) * c * elem_bytes
    slots = min(RMS_MAX_SLOTS, (_SMEM_BLOCK - 8 * RMS_MAX_SLOTS) // slot)
    smem = slots * slot + 8 * slots
    cap = RMS_BLOCKS[0 if c == RMS_EXACT_C else 1]
    per_sm = min(cap, _SMEM_SM // (smem + _SMEM_STATIC + _SMEM_RESERVED))
    return RmsPlan(slots, smem, per_sm, min(rows, per_sm * sms))


def add_rmsnorm_quant_dyn_torch(a, branch, weight, eps: float):
    """Plain twin of K8c, in the TPU kernel's arithmetic
    (`fused_ln.py:108-116`): resid = a [+ branch in a's dtype],
    y = resid * rsqrt(mean(resid^2) + eps) * weight in fp32,
    sx = max(amax|y|, 1e-9) * (1/127) and q = round(y * (1/sx)) clipped to
    +-127. Returns (resid, q int8, sx (..., 1) fp32)."""
    resid = a if branch is None else a + branch.to(a.dtype)
    xf = resid.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.float()
    sx = y.abs().amax(-1, keepdim=True).clamp_min(1e-9) * (1.0 / 127.0)
    q = torch.clamp(torch.round(y * (1.0 / sx)), -127, 127).to(torch.int8)
    return resid, q, sx


def add_rmsnorm_quant_dyn(a, branch, weight, *, eps: float = 1e-6):
    """Residual add + RMSNorm + dynamic per-token int8 quant
    (`fused_ln.py:119-177`): (resid, q8, sx) with resid = a + branch in
    a's dtype, or `a` itself when `branch` is None, and
    rmsnorm(resid) ~= q8 * sx, sx (..., 1) fp32.

    CPU tensors take `add_rmsnorm_quant_dyn_torch`; CUDA tensors launch
    `csrc/rmsnorm_quant.cu` once (C a multiple of 128, at most RMS_MAX_C),
    persistent CTAs streaming rows through a ring as `_rms_plan` says. The
    JAX package's non-kernel chain for other C has no caller in the model
    (the fused-norm carry requires C % 128 == 0) and is not ported."""
    w = weight.float().contiguous()
    if branch is not None:
        branch = branch.to(a.dtype)
    tensors = (a, w) if branch is None else (a, branch, w)
    if _kernels.on_cpu(*tensors):
        return add_rmsnorm_quant_dyn_torch(a, branch, w, eps)
    name = "rmsnorm_quant" if branch is None else "add_rmsnorm_quant"
    c = a.shape[-1]
    if c % 128 or c > RMS_MAX_C:
        raise ValueError(f"{name}: C = {c} must be a multiple of 128 and at "
                         f"most {RMS_MAX_C}")
    dt = _kernels.dtype_code(name, a)
    a = a.contiguous()
    pairs = [(a, a.dtype), (w, torch.float32)]
    if branch is not None:
        branch = branch.contiguous()
        if branch.shape != a.shape:
            raise ValueError(f"{name}: branch {tuple(branch.shape)} against "
                             f"a {tuple(a.shape)}")
        pairs.append((branch, a.dtype))
    _kernels.check_typed(name, pairs)
    if w.shape != (c,) or any(t.data_ptr() % 16 for t, _ in pairs):
        raise ValueError(f"{name}: weight {tuple(w.shape)} for C = {c}, or "
                         "an input not 16-byte aligned")
    rows = a.numel() // c
    q = torch.empty(a.shape, device=a.device, dtype=torch.int8)
    sx = torch.empty((*a.shape[:-1], 1), device=a.device,
                     dtype=torch.float32)
    st = _kernels.stream_ptr(a)
    with torch.cuda.device(a.device):
        if branch is None:
            _kernels.KERNELS[name](a.data_ptr(), w.data_ptr(), q.data_ptr(),
                                   sx.data_ptr(), rows, c, float(eps), dt, st)
            return a, q, sx
        resid = torch.empty_like(a)
        _kernels.KERNELS[name](a.data_ptr(), branch.data_ptr(), w.data_ptr(),
                               resid.data_ptr(), q.data_ptr(), sx.data_ptr(),
                               rows, c, float(eps), dt, st)
    return resid, q, sx
