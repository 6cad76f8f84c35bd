"""Worker programs of the parallel paths, one per rank under
`parallel.launch`: a train step or a greedy decode of a `GroveModel`
(`tiny()` by default, `small()` with "size") under a ("data", "model")
mesh, whose results rank 0 writes to a file for the caller to compare with
an unsharded run. They run on the card (several ranks on one card over
gloo), or with "device": "cpu" on the CPU.

    python -m grove_tpu_torch.parallel.workers train_step '{"weights": ...}'

They live in the port, not beside the tests, because a spawned process
imports its target's module and must import no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as pmesh


def grove_config(overrides: Optional[Dict] = None, size: str = "tiny"):
    """`GroveConfig.tiny()` (or `.small()`) with `overrides` ({"field":
    value}, or {"llama.field": value} for the LLaMA's)."""
    from ..config import GroveConfig
    cfg = getattr(GroveConfig, size)()
    top, llama = {}, {}
    for k, v in (overrides or {}).items():
        (llama if k.startswith("llama.") else top)[k.split(".")[-1]] = v
    if llama:
        top["llama"] = dataclasses.replace(cfg.llama, **llama)
    return dataclasses.replace(cfg, **top)


def _model(cfg, weights: str, mesh, sp: bool, device):
    from ..models.grove import GroveModel
    model = GroveModel(cfg, device=device, dtype=torch.float32,
                       llm_act_sharding=mesh if sp else None)
    model.load_state_dict(torch.load(weights, weights_only=True))
    return model.eval()


def _whole(tensors: Dict[str, torch.Tensor], mesh
           ) -> Dict[str, torch.Tensor]:
    """Whole CPU copies of `tensors` (parameters or gradients, DTensors or
    plain) on rank 0 ({} elsewhere), through `full_state_dict`; where
    ranks share a card over gloo, each rank's local shards travel as
    pickled CPU tensors (`all_gather_object`), so gloo needs no collective
    on CUDA tensors, and a tensor-parallel shard is put back by its
    placement on "model"."""
    from torch.distributed.tensor import DTensor, Shard
    from .sharding import full_state_dict
    if mesh.device_type == "cpu" or dist.get_backend() != "gloo":
        whole = full_state_dict(dict(tensors))
        return ({k: v.detach().cpu().clone() for k, v in whole.items()}
                if dist.get_rank() == 0 else {})
    mine = {n: (t.to_local() if isinstance(t, DTensor) else t
                ).detach().cpu() for n, t in tensors.items()}
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, mine)
    if dist.get_rank() != 0:
        return {}
    out = {}
    tp = pmesh.axis_size(mesh, "model")
    # the ranks of data index 0 in model order: the first tp ranks
    for n, t in tensors.items():
        pl = t.placements[-1] if isinstance(t, DTensor) else None
        if isinstance(pl, Shard):
            out[n] = torch.cat([got[r][n] for r in range(tp)], dim=pl.dim)
        else:
            out[n] = got[0][n]
    return out


def train_step(weights: str, batches: str, out: str, tp: int = 1,
               fsdp: bool = False, sp: bool = False, zero: bool = False,
               min_size: int = 1 << 8, steps: int = 2,
               config: Optional[Dict] = None,
               optimizer: Optional[Dict] = None, size: str = "tiny",
               device: str = "cuda") -> None:
    """`steps` steps of `train.step.make_train_step` under a (world / tp,
    tp) mesh on `device`: data rank r takes batches[r] (a `torch.save`d
    list of numpy batch dicts), the model its tensor-parallel plans
    (`tp`), FSDP (`fsdp`, parameters of at least `min_size` elements),
    sequence parallelism (`sp`) or ZeRO-2 moments (`zero`). Rank 0 writes
    {"metrics": [each step's loss terms], "params": whole trainable
    parameters after the last step, "grads": their whole gradients of the
    first step} to `out`."""
    from ..train.step import (OptimizerConfig, batch_to_device,
                              make_optimizer, make_train_step,
                              partition_params, trainable_mask)
    from .sharding import shard_pytree, zero_sharding
    dev = _device(device)
    mesh = pmesh.make_mesh(model=tp, device_type=dev.type)
    cfg = grove_config(config, size)
    model = _model(cfg, weights, mesh, sp, dev)
    ocfg = OptimizerConfig(**(optimizer or {}))
    mask = trainable_mask(model, ocfg)
    partition_params(model, mask)
    shard_pytree(model, mesh, fsdp=fsdp, min_size=min_size)
    params = {n: p for n, p in model.named_parameters() if mask[n]}
    opt = make_optimizer(params, ocfg)
    if zero:
        opt.shard_state_(mesh, zero_sharding(model, mesh))
    step = make_train_step(model, opt, mesh)
    local = torch.load(batches, weights_only=False)[
        pmesh.axis_rank(mesh, "data")]
    metrics, grads = [], None
    for _ in range(steps):
        m = step(batch_to_device(local, dev))
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            # the first step's: both runs' weights are still the same
            grads = _whole({n: p.grad for n, p in params.items()
                            if p.grad is not None}, mesh)
    whole = _whole(params, mesh)
    if dist.get_rank() == 0:
        torch.save({"metrics": metrics, "params": whole, "grads": grads},
                   out)


def greedy(weights: str, inputs: str, out: str, tp: int = 1,
           max_new_tokens: int = 5, config: Optional[Dict] = None,
           device: str = "cuda") -> None:
    """`infer.generate.greedy_decode` under a (world / tp, tp) mesh with
    the tensor-parallel plans, an fp32 cache; data rank r decodes rows
    r::data of `inputs` ({"ids", "feats", "starts"} numpy); rank 0 writes
    every row's tokens, gathered, to `out`."""
    from ..infer.generate import greedy_decode
    from .sharding import shard_pytree
    dev = _device(device)
    mesh = pmesh.make_mesh(model=tp, device_type=dev.type)
    cfg = grove_config(config)
    model = _model(cfg, weights, mesh, False, dev)
    shard_pytree(model, mesh)
    data = torch.load(inputs, weights_only=False)
    r, n = pmesh.axis_rank(mesh, "data"), pmesh.axis_size(mesh, "data")
    rows = np.arange(len(data["ids"]))[r::n]
    with torch.inference_mode():
        gen, _ = greedy_decode(
            model, torch.as_tensor(data["ids"][rows]).to(dev),
            torch.as_tensor(data["feats"][rows]).to(dev),
            data["starts"][rows],
            max_new_tokens=max_new_tokens, eos_id=cfg.tokens.eos,
            cache_dtype=torch.float32)
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, {int(i): t for i, t in
                                 zip(rows, gen.tolist())})
    if dist.get_rank() == 0:
        merged = {}
        for part in got:
            merged.update(part)
        torch.save([merged[i] for i in range(len(data["ids"]))], out)


WORKERS = {"train_step": train_step, "greedy": greedy}


def _device(name: str) -> torch.device:
    """The device `init_distributed` gave this rank, of `name`'s type."""
    if name == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    name, kwargs = argv[0], json.loads(argv[1]) if len(argv) > 1 else {}
    torch.set_num_threads(1)
    pmesh.init_distributed(kwargs.get("device", "cuda"))
    try:
        WORKERS[name](**kwargs)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
