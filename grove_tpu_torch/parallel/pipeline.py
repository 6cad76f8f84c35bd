"""GPipe pipeline parallelism for the LLaMA decoder stack.

Counterpart of `grove_tpu/parallel/pipeline.py`. The JAX package stacks
the layers' parameters on a leading axis sharded over a "pipe" mesh axis
and runs the GPipe schedule in one `shard_map` program: at step t, stage k
runs microbatch t - k and hands its activation to stage k + 1 with
`ppermute`. The port's pipeline is one process over a list of devices:

* `make_pipe_mesh(n_stages, devices)` names the stages' devices. Where
  JAX asserts `n_stages <= len(devices)`, the port takes an explicit list
  that may repeat a device: on one card every stage sits on `cuda:0`.
  There is no pipeline across processes;
* `place_stages` moves stage k's `num_layers / n_stages` layers onto its
  device and records each layer's device in `LlamaModel.stages`, so that
  the model's own forward carries its activations from stage to stage
  (`.to(device)`; autograd carries the backward through the moves);
* `pipelined_llama_forward` runs that forward once a microbatch, in order.
  Kernel launches are asynchronous, so while the host enqueues microbatch
  i on stage k's card, the card of stage k + 1 can still run microbatch
  i - 1: the GPipe schedule, left to the cards' queues. The result is
  the same as one `LlamaModel.forward` of the whole batch (the final
  RMSNorm is per row), with the same gradients; `remat` is the model's
  own (each layer under `torch.utils.checkpoint`), as JAX's
  `jax.checkpoint` on the layer body. The bubble and the overlap across
  cards were not measured.

Scope, as in JAX: the cache-free (training, teacher-forced) pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

LAYER = "layers."


def stack_block_params(llama: nn.Module, num_layers: int
                       ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Split a LLaMA's parameters (a `LlamaModel`, or its state dict) into
    (stacked block parameters, rest) (`pipeline.py:43`): each
    `layers.{i}.<name>` stacked on a new leading axis of `num_layers` as
    `<name>`; `rest` holds the others (the embedding and the final norm)
    unchanged."""
    sd = llama.state_dict() if isinstance(llama, nn.Module) else dict(llama)
    per = [{k[len(f"{LAYER}{i}."):]: v for k, v in sd.items()
            if k.startswith(f"{LAYER}{i}.")} for i in range(num_layers)]
    stacked = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    rest = {k: v for k, v in sd.items() if not k.startswith(LAYER)}
    return stacked, rest


def unstack_block_params(stacked: Dict[str, torch.Tensor], num_layers: int
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of `stack_block_params` without `rest` (`pipeline.py:55`):
    `layers.{i}.<name>` state-dict entries."""
    return {f"{LAYER}{i}.{k}": v[i] for i in range(num_layers)
            for k, v in stacked.items()}


@dataclass(frozen=True)
class PipeMesh:
    """The stages' devices, stage k on devices[k]."""
    devices: Tuple[torch.device, ...]

    @property
    def n_stages(self) -> int:
        return len(self.devices)


def make_pipe_mesh(n_stages: int,
                   devices: Optional[Sequence] = None) -> PipeMesh:
    """The first `n_stages` of `devices` (`pipeline.py:61`); by default one
    card each, which needs `n_stages` cards. A list may repeat a device."""
    if devices is None:
        count = torch.cuda.device_count()
        if n_stages > count:
            raise ValueError(f"make_pipe_mesh: {n_stages} stages, {count} "
                             "CUDA devices (pass devices=, which may "
                             "repeat one)")
        devices = [torch.device("cuda", i) for i in range(n_stages)]
    devices = [torch.device(d) for d in devices]
    if n_stages > len(devices):
        raise ValueError(f"make_pipe_mesh: {n_stages} stages, "
                         f"{len(devices)} devices")
    return PipeMesh(tuple(devices[:n_stages]))


def _stage_of(num_layers: int, n_stages: int) -> List[int]:
    if num_layers % n_stages:
        raise ValueError(f"pipeline: {num_layers} layers do not divide into "
                         f"{n_stages} stages")
    per = num_layers // n_stages
    return [i // per for i in range(num_layers)]


def place_stages(llama: nn.Module, pipe: PipeMesh) -> nn.Module:
    """Move each decoder layer of `llama` (a `LlamaModel`) onto its
    stage's device, in place, and record the layers' devices in
    `llama.stages`. Its cache-free passes (the driver's validation too)
    then run stage after stage; a pass with KV caches needs every stage on
    one device."""
    stages = [pipe.devices[k] for k in _stage_of(len(llama.layers),
                                                 pipe.n_stages)]
    for layer, dev in zip(llama.layers, stages):
        layer.to(dev)
    llama.stages = stages
    return llama


def pipelined_llama_forward(llama: nn.Module, inputs_embeds: torch.Tensor,
                            positions: torch.Tensor, pipe: PipeMesh,
                            n_microbatches: int) -> torch.Tensor:
    """Post-final-norm hidden states of `llama` (a `LlamaModel`) with its
    decoder stack run over `pipe`'s stages in `n_microbatches`
    microbatches (`pipeline.py:68`; see the module docstring).
    inputs_embeds (B, S, D) with B divisible by `n_microbatches`;
    positions (S,) shared by the batch. The layers are placed on their
    stages first where `place_stages` has not placed them; the result
    lies on the final norm's device."""
    m = n_microbatches
    if inputs_embeds.shape[0] % m:
        raise ValueError(f"pipelined_llama_forward: batch "
                         f"{inputs_embeds.shape[0]} does not divide into {m} "
                         "microbatches")
    if llama.stages != [pipe.devices[k] for k in _stage_of(
            len(llama.layers), pipe.n_stages)]:
        place_stages(llama, pipe)
    return torch.cat([llama(mb, positions)
                      for mb in inputs_embeds.chunk(m, dim=0)], dim=0)
