"""Process group, device mesh and the data-parallel plumbing.

Counterpart of `grove_tpu/parallel/mesh.py`. The reference runs NCCL
DDP / ZeRO-2 (`train.py:466-487`); the JAX package names its devices in a
`jax.sharding.Mesh` with a "data" and a "model" axis and lets XLA insert
the collectives. The port runs one process per device (JAX's virtual
devices per process have no counterpart) and names them in a
`torch.distributed` `DeviceMesh` with the same two axes:

  "data"   batch / ZeRO / FSDP axis (the reference's DDP ranks);
  "model"  the tensor-parallel axis of `parallel.sharding`.

`init_distributed` is the counterpart of `jax.distributed.initialize()`
(`grove_tpu/train/driver.py:281-285`): it reads torchrun's environment.
Placements are DTensor's: `replicated` and `data_sharded` give the
(data, model) placements JAX writes as `P()` and `P("data")`.

JAX computes one SPMD loss over the global batch; here every data rank
holds its local batch (`globalize_batch`), sums its counts with the
others' (`count_reduce`) so that each normalizer is the global batch's,
and the gradients and the reported losses are summed over "data"
(`sync_gradients`, `reduce_metrics`): the loss and gradients of the
global batch.

Sequence parallelism (`seq_slice`, `seq_gather`, `seq_rms_norm`): the
LLaMA's residual stream kept as this rank's (B, S / tp, D) slice between
blocks (`models.llama.LlamaModel.act_sharding`).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
TIMEOUT_S = 600


def init_distributed(device: str = "cuda") -> torch.device:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    returns this rank's device. On "cuda" each rank takes card
    LOCAL_RANK % device_count over NCCL where every local rank has a card
    of its own, and over gloo where ranks share a card (NCCL refuses two
    ranks on one device); on "cpu", gloo. A CUDA device without a card
    raises: no rank falls back to the CPU. A rendezvous that does not
    complete within TIMEOUT_S raises."""
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", 1)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is "
                               "available (pass device='cpu')")
        n = torch.cuda.device_count()
        device = torch.device("cuda", local % n)
        torch.cuda.set_device(device)
        backend = "nccl" if local_world <= n else "gloo"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: device {device} is neither "
                         "cuda nor cpu")
    if not dist.is_initialized():
        kw = dict(backend=backend, init_method="env://",
                  timeout=datetime.timedelta(seconds=TIMEOUT_S))
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(**kw)
    return device


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda"):
    """A ("data", "model") `DeviceMesh` over the world (`mesh.py:22`);
    `data` defaults to world // model. On the card unless `device_type`
    is "cpu" (a gloo group on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"make_mesh: data {data} x model {model} != world "
                         f"{world}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def replicated(mesh) -> Tuple:
    """(data, model) placements of `P()` (`mesh.py:35`)."""
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


def data_sharded(mesh, ndim: int = 1) -> Tuple:
    """(data, model) placements of `P("data")` (`mesh.py:39`): the leading
    (batch) dim over "data", whatever the rank `ndim`."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def globalize_batch(batch: Dict, mesh, device=None) -> Dict:
    """This rank's local batch as tensors on its device (`mesh.py:44`).
    The global batch is the local batch times the "data" size: every rank
    of one "data" index must hold the same rows, and the step sums counts,
    losses and gradients over "data" (`count_reduce`, `sync_gradients`).
    With a world of 1 it is the batch on `device`."""
    from ..train.step import batch_to_device
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh is not None and mesh.device_type == "cuda"
                  else torch.device("cpu"))
    return batch_to_device(batch, device)


def global_batch_size(batch: Dict, mesh) -> int:
    return int(np.shape(batch["input_ids"])[0]) * axis_size(mesh, "data")


def _data_group(mesh, group=None):
    """`group` where given (the ranks of a pipeline), else the "data" group
    of `mesh` (None without data parallelism)."""
    if group is not None:
        return group
    if mesh is None or axis_size(mesh, "data") == 1:
        return None
    return mesh.get_group("data")


def count_reduce(mesh, group=None):
    """A function that sums a count over "data", or over `group` where
    given (None without either): `ops.losses`' `count_reduce`."""
    group = _data_group(mesh, group)
    if group is None:
        return None

    def reduce(count: torch.Tensor) -> torch.Tensor:
        total = count.detach().clone()
        dist.all_reduce(total, group=group)
        return total
    return reduce


def _fsdp_managed(p) -> bool:
    """A parameter FSDP shards over "data" (its gradient is reduced by
    FSDP's reduce-scatter)."""
    from torch.distributed.tensor import DTensor
    return (isinstance(p, DTensor) and p.device_mesh.mesh_dim_names
            is not None and "data" in p.device_mesh.mesh_dim_names)


@torch.no_grad()
def sync_gradients(params: Dict[str, torch.nn.Parameter], mesh,
                   group=None) -> None:
    """Sum the gradients of `params` over "data" (or over `group` where
    given): FSDP's shards, which its reduce-scatter averaged, times the
    "data" size; the others (plain and tensor-parallel parameters) by one
    all-reduce per dtype of the flattened local gradients. A trainable
    parameter without a gradient takes zeros, as optax sees them."""
    from torch.distributed.tensor import DTensor
    group = _data_group(mesh, group)
    if group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params.values():
        if _fsdp_managed(p):
            if p.grad is not None:
                p.grad.to_local().mul_(axis_size(mesh, "data"))
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        g = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
        by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh, group=None
                   ) -> Dict[str, torch.Tensor]:
    """Each rank's share of the loss terms summed over "data" (or over
    `group` where given): the global batch's terms, equal on every
    rank."""
    group = _data_group(mesh, group)
    if group is None:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=group)
    return dict(zip(keys, flat.unbind()))


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

def seq_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    """(B, S, D), the same on every rank of the 1-D "model" `mesh` ->
    this rank's (B, S / tp, D) slice; its backward all-gathers the
    gradient."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor.from_local(x, mesh, [Replicate()], run_check=False
                              ).redistribute(mesh, [Shard(1)]).to_local()


def seq_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (B, S / tp, D) slice -> the whole (B, S, D) (an
    all-gather); its backward takes this rank's slice of the gradient."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor.from_local(x, mesh, [Shard(1)], run_check=False
                              ).redistribute(mesh, [Replicate()]).to_local()


class _SumGradOverGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over `group` (a
    replicated weight applied to each rank's own tokens)."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def seq_rms_norm(norm, x: torch.Tensor, mesh) -> torch.Tensor:
    """`norm` (a `models.layers.RMSNorm`) on this rank's slice of the
    sequence, its weight's gradient summed over the "model" ranks."""
    from ..models.layers import rms_norm
    w = norm.weight
    if w.requires_grad and torch.is_grad_enabled():
        w = _SumGradOverGroup.apply(w, mesh.get_group())
    return rms_norm(x, w, norm.eps)
