"""Low-memory optimizer pieces for the single-card fine-tune (the QLoRA
recipe): AdamW with bf16 moments, and stochastic rounding of bf16
parameters.

Counterpart of `grove_tpu/train/lowmem.py`. The reference fine-tunes with
DeepSpeed ZeRO-2 on 16 x 8 GPUs; the JAX package fits the recipe on one
chip by shrinking the byte consumers, and so does the port:

* frozen LLM projections -> packed int4 (`GroveForCausalLM.quantize(
  bits=4)`); the backward through them rebuilds each weight view
  (`models.layers.Int4Linear`);
* AdamW moments (8 B / parameter in fp32) -> bf16 (`adamw_bf16`): the
  update math runs in fp32 every step, only the stored moments are bf16
  (`lowmem.py:59-71`);
* bf16 parameters with stochastic rounding on the update
  (`apply_updates_sr`), so that updates below half a bf16 ULP accumulate in
  expectation instead of vanishing (a plain bf16 add drops any update
  smaller than ~0.4% of the parameter).

They compose as `benchmarks/train_finetune_scale.py:200-211` composes
them: backward, `updates = optimizer.update()`, then
`apply_updates_sr(params, updates, generator)`; `optimizer.step()` is the
plain add instead (optax's `apply_updates`).

The random stream differs from JAX's (a `torch.Generator`, one draw per
tensor in order, against `jax.random` keys split per leaf): the contract
is unbiasedness, exactness for sums that bf16 already holds, and
determinism under a seeded generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .step import EPS, AdamW

_BF16_MASK = -65536           # 0xFFFF0000 as an int32: the bf16 bits of fp32


class AdamWBf16(AdamW):
    """`adamw_bf16` (`lowmem.py:86-100`): `AdamW`'s chain (clip over the
    trainable set, Adam, decoupled weight decay, `-lr` of the count before
    the increment) with `scale_by_adam_compact` as its Adam: moments stored
    in bf16, the math in fp32 (mu = b1 mu + (1 - b1) g, nu = b2 nu +
    (1 - b2) g^2, fp32 bias corrections with the incremented count,
    mu_hat / (sqrt(nu_hat) + eps)), so the updates are fp32."""

    @staticmethod
    def _zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p, dtype=torch.bfloat16)

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor:
        """Global norm of the trainable gradients as `optax.global_norm`
        takes it (0-dim, on the parameters' device: no host sync): each
        leaf's squares in its own dtype, summed with an fp32 accumulator
        and rounded to that dtype, the leaf sums added in their promoted
        dtype, the square root in it (bf16 for bf16 gradients)."""
        total = None
        for s, dtype in self._leaf_sq_sums(lambda g: (g * g).float()):
            s = s.to(dtype)
            total = s if total is None else total + s
        return torch.zeros(()) if total is None else total.sqrt()

    def _bias_corrections(self, count: int):
        # in fp32, as `b1 ** count` over an fp32 count
        cf = torch.tensor(float(count), dtype=torch.float32)
        return tuple(float(1 - torch.tensor(b, dtype=torch.float32) ** cf)
                     for b in (self.b1, self.b2))

    def _adam(self, name, g, bc1, bc2):
        b1, b2 = self.b1, self.b2
        g32 = g.float()
        m32 = b1 * self.mu[name].float() + (1 - b1) * g32
        v32 = b2 * self.nu[name].float() + (1 - b2) * g32 * g32
        self.mu[name].copy_(m32)
        self.nu[name].copy_(v32)
        return (m32 / bc1) / (torch.sqrt(v32 / bc2) + EPS)


def adamw_bf16(params: Dict[str, nn.Parameter], schedule, *,
               b1: float = 0.9, b2: float = 0.999, weight_decay: float = 0.0,
               grad_clip: Optional[float] = None) -> AdamWBf16:
    """AdamW with bf16 moments over `params` (`lowmem.py:86-100`);
    `schedule` maps the step count to the learning rate; a `grad_clip` of
    None or 0 leaves out the clip, as JAX's `if grad_clip`."""
    return AdamWBf16(params, schedule, b1=b1, b2=b2,
                     weight_decay=weight_decay, grad_clip=grad_clip or None)


@torch.no_grad()
def apply_updates_sr(params: Dict[str, nn.Parameter],
                     updates: Dict[str, torch.Tensor],
                     generator: torch.Generator) -> None:
    """`optax.apply_updates` with stochastic rounding into bf16
    (`lowmem.py:103-136`), IN PLACE: for a bf16 parameter, x = p + u in
    fp32, U[0, 2^16) added to x's bits and the low 16 bits cleared, so x
    rounds up with probability equal to its remainder below the bf16 LSB
    (E[p_new] = p + u for finite x; a sum bf16 already holds comes back
    exactly). The int32 view's wrap-around add gives the bits of JAX's
    uint32 add and mask. Other dtypes take a plain add. `generator` lies
    on the parameters' device; its draws go to the tensors in the order of
    `updates`."""
    for name, u in updates.items():
        p = params[name]
        if p.dtype != torch.bfloat16:
            p.copy_(p + u.to(p.dtype))
            continue
        x = p.float() + u.float()
        noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                              device=x.device, dtype=torch.int32)
        bits = (x.view(torch.int32) + noise) & _BF16_MASK
        p.copy_(bits.view(torch.float32))
