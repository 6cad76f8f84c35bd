"""LayerNorm -> static int8 quantize, alone (K8a) or after a residual add
(K8b).

Counterpart of `grove_tpu/ops/fused_ln.py:29-94` (`add_layernorm_quant`)
and `:180-236` (`layernorm_quant`). The calibrated activation scale folds
into gamma and beta in fp32 OUTSIDE the kernel, gs = gamma / act_scale and
bs = beta / act_scale, so that

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

from typing import Tuple

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
