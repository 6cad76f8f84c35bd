"""Weight quantisers for serving, in torch (any device).

Counterpart of the weight side of `grove_tpu/ops/quant.py`, with the same
layouts and names, so the port's buffers hold the same bytes as the JAX
package's parameter tree and carry over without a converter:

* int8 per output channel (`quantize_kernel`): kernel_q (K, N) int8 and
  scale (N,) fp32, absmax / 127;
* int4 per (group, output) (`quantize_kernel_int4`): kernel_q4p (K/2, N)
  int8, group-pair packed (`pack_int4`), and scale (K/G, N) fp32,
  absmax / 7.

Kernels are (in, out) = (K, N), the JAX layout: the transpose of an
`nn.Linear` weight. Both libraries round half to even and divide in fp32,
so the results are byte-identical to the numpy originals.

`quantize_llama_` is the module transform of `quantize_llama_tree` /
`quantize_llama_tree_int4`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

LLAMA_PROJECTIONS = (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                     ("mlp", ("gate_proj", "up_proj", "down_proj")))


def quantize_kernel(kernel: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(..., in, out) -> int8 kernel + per-output-channel fp32 scale (max
    over every non-output axis), `quant.py:64-73`. The results are
    contiguous whatever the layout of `kernel` (e.g. a transposed
    `nn.Linear` weight)."""
    k = kernel.float().contiguous()
    scale = k.reshape(-1, k.shape[-1]).abs().amax(0) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale


def int4_group(k_in: int, group: int) -> int:
    """The group size `quantize_kernel_int4` and `Int4Dense` use for an input
    width: `group`, halved until 2 * group divides it (`quant.py:157-158`,
    for narrow test configs)."""
    while group > 1 and k_in % (2 * group):
        group //= 2
    if k_in % (2 * group):
        raise ValueError(f"int4: input width {k_in} has no even group count")
    return group


def pack_int4(q: torch.Tensor, group: int) -> torch.Tensor:
    """int4 values (K, N) int8 in [-8, 7] -> PACKED (K/2, N) int8: packed
    row p*G + i holds logical row 2p*G + i in its low nibble and
    (2p+1)*G + i in its high nibble (`quant.py:109-129`)."""
    kin, out = q.shape
    if kin % (2 * group):
        raise ValueError(f"pack_int4: {kin} rows, group {group}")
    v = q.reshape(kin // (2 * group), 2, group, out).to(torch.int32)
    packed = (v[:, 0] & 0x0F) | ((v[:, 1] & 0x0F) << 4)
    # the byte 0..255 as a signed int8, as numpy's astype(np.int8) wraps it
    packed = torch.where(packed > 127, packed - 256, packed)
    return packed.to(torch.int8).reshape(kin // 2, out)


def unpack_int4(packed: torch.Tensor, group: int) -> torch.Tensor:
    """PACKED (K/2, N) int8 -> (K/G groups, G, N) int8 values; the inverse
    of `pack_int4` (`quant.py:132-142`)."""
    half, out = packed.shape
    s = half // group
    p32 = packed.reshape(s, group, out).to(torch.int32)
    lo = (p32 << 28) >> 28                 # sign-extended low nibble
    hi = p32 >> 4                          # arithmetic: high nibble
    return torch.stack([lo, hi], dim=1).reshape(2 * s, group, out).to(
        torch.int8)


def quantize_kernel_int4(kernel: torch.Tensor, group: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) -> (packed (K/2, N) int8, scale (K/G, N) fp32): group-wise
    round-to-nearest absmax over `group`-row slices of the input dim,
    q = round(k / s) in [-7, 7], s = absmax / 7 (`quant.py:145-165`).
    The results are contiguous whatever the layout of `kernel`."""
    k = kernel.float().contiguous()
    kin, out = k.shape
    group = int4_group(kin, group)
    g = k.reshape(kin // group, group, out)
    scale = (g.abs().amax(1) / 7.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(g / scale[:, None, :]), -7, 7)
    return pack_int4(q.reshape(kin, out).to(torch.int8), group), scale


@torch.no_grad()
def quantize_llama_(model: nn.Module, bits: int, group: int = 128):
    """Quantise a `models.grove.GroveModel`'s LLM IN PLACE: the seven
    projections of every layer become `Int4Linear` (bits=4, group-wise) or
    `Int8Linear` (bits=8), and `lm_head` becomes `Int8Linear` either way
    (`quant.py:103-106`, `:179-204`). It works layer by layer on the
    model's device and drops each float weight once its quantised buffers
    exist, so a full-width model quantises on the card without two copies.
    `model.cfg` is updated to `weight_quant=True, weight_quant_bits=bits`.
    Returns the model."""
    from ..models.layers import Int4Linear, Int8Linear
    if bits not in (4, 8):
        raise ValueError(f"quantize_llama_: bits must be 4 or 8, got {bits}")
    llama = dataclasses.replace(model.cfg.llama, weight_quant=True,
                                weight_quant_bits=bits, quant_group=group)

    def swap(parent: nn.Module, name: str, int4: bool):
        lin = getattr(parent, name)
        if not isinstance(lin, nn.Linear):
            raise TypeError(f"quantize_llama_: {name} is "
                            f"{type(lin).__name__}, not nn.Linear (already "
                            "quantized?)")
        kernel = lin.weight.t()            # (in, out), the JAX layout
        new = (Int4Linear.from_kernel(kernel, group) if int4
               else Int8Linear.from_kernel(kernel))
        setattr(parent, name, new)

    for layer in model.model.layers:
        for sub, names in LLAMA_PROJECTIONS:
            for name in names:
                swap(getattr(layer, sub), name, bits == 4)
        layer.self_attn.cfg = llama
    swap(model, "lm_head", False)
    model.cfg = dataclasses.replace(model.cfg, llama=llama)
    return model
