"""Worker programs of the parallel paths, one per rank under
`parallel.launch`: a train step or a greedy decode of a `GroveModel`
(`tiny()` by default, `small()` with "size") under a ("data", "model")
mesh, the pipelined step one stage a rank, or the training driver in
another dtype, whose results rank 0 writes to a file for the caller to
compare with an unsharded run. They run on the card (several ranks on one
card over gloo), or with "device": "cpu" on the CPU.

    python -m grove_tpu_torch.parallel.workers train_step '{"weights": ...}'

They live in the port, not beside the tests, because a spawned process
imports its target's module and must import no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
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


class StageTimer:
    """`timer(kind, i)` of `parallel.pipeline.rank_forward`: CUDA events
    around each microbatch's work on this stage (host clocks on the CPU),
    read back as (kind, i, start s, end s) on the host's monotonic clock,
    which every process of one host shares: each event's time from an
    anchor event recorded when the card was idle at a known host time."""

    def __init__(self, cuda: bool):
        self.cuda, self.marks = cuda, []

    def start(self) -> None:
        self.marks = []
        if self.cuda:
            torch.cuda.synchronize()
            self.anchor = torch.cuda.Event(enable_timing=True)
            self.t0 = time.perf_counter()
            self.anchor.record()

    @contextlib.contextmanager
    def __call__(self, kind: str, i: int):
        if not self.cuda:
            t = time.perf_counter()
            yield
            self.marks.append((kind, i, t, time.perf_counter()))
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.marks.append((kind, i, start, end))

    def read(self):
        if not self.cuda:
            return list(self.marks)
        torch.cuda.synchronize()

        def at(event):
            return self.t0 + self.anchor.elapsed_time(event) / 1e3
        return [(k, i, at(s), at(e)) for k, i, s, e in self.marks]


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def bit_sums(tensors: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """The sum of the bits of each float tensor of `tensors` that has
    storage, read as integers, by name: exact and independent of the order
    of the sum."""
    return {n: int(t.contiguous().view(_BITS[t.element_size()]).long().sum())
            for n, t in tensors.items()
            if not t.is_meta and t.is_floating_point()}


def fingerprint(model) -> Dict[str, int]:
    """`bit_sums` of every tensor `model` holds."""
    return bit_sums(model.state_dict())


def pipeline_step(out: str, batch: str, microbatches: int,
                  weights: Optional[str] = None,
                  config_file: Optional[str] = None,
                  seed: int = 0, dtype: str = "fp32",
                  optimizer: Optional[Dict] = None, warm_steps: int = 0,
                  steps: int = 1, remat: bool = False, grads: bool = True,
                  val: bool = False, tf32=None, replicas: int = 1,
                  device: str = "cuda") -> None:
    """Steps of `train.step.make_pipelined_train_step` one stage a rank
    (`parallel.pipeline.RankPipe`) on `device`, `replicas` replicas of
    world / `replicas` stages: rank r takes its rows of the global batch
    in `batch` (a `torch.save`d numpy batch dict). The
    model is the pickled GroveConfig in `config_file` (`tiny()` without
    one), built from `seed` in `dtype` with each rank holding its stage's
    layers only, each layer under `torch.utils.checkpoint` with `remat`,
    the whole `weights` laid over where given.
    `tf32`: where given, (cuBLAS's, cuDNN's) `allow_tf32`, as the caller
    holds them, so that an fp32 op takes the caller's algorithms.
    `warm_steps` untimed steps first, then `steps` timed ones, each with
    the launch counts set to 0 just before it and `StageTimer` marks.
    Rank 0 writes {"ranks": each rank's {"stage", "replica", "held" (its
    layers with storage), "meta" (the others'), "transport", "stage_bytes"
    (the bytes of its layers' trainable parameters, as of their
    gradients), "fingerprint", "after" (`bit_sums` of its parameters and
    moments after the last step), "steps" ("launches", "ms", "peak", "marks" by
    step; with replicas, a "stage_sum" mark around the stage group's
    gradient sum), "val" (with `val`: `RankPipelineModel`'s forward_boxes
    and forward_train on its rows)}, "metrics": each timed step's loss
    terms, "norm": the clipping norm of the last step's gradients,
    "grads": the whole trainable gradients of the first timed step and
    "params": the whole trainable parameters after the last (with
    `grads`; replica 0's)} to `out`."""
    import pickle
    from .. import _kernels
    from ..models.grove import init_grove_params
    from ..train.step import (OptimizerConfig, batch_to_device,
                              make_optimizer, make_pipelined_train_step,
                              partition_params, trainable_mask)
    from .pipeline import (LAYER_KEY, RankPipelineModel, gather_stages,
                           local_rows, make_rank_pipe, stage_layers)
    from .sharding import load_full_state_dict
    dev = _device(device)
    if tf32 is not None:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    if config_file:
        with open(config_file, "rb") as f:
            cfg = pickle.load(f)
    else:
        cfg = grove_config()
    n, rank = dist.get_world_size() // replicas, dist.get_rank()
    num_layers = cfg.llama.num_layers
    layers = stage_layers(num_layers, n, rank % n)
    model = init_grove_params(
        cfg, device=dev, seed=seed, remat=remat, layers=layers,
        dtype=DTYPES[dtype])
    if weights:
        load_full_state_dict(model, torch.load(weights, weights_only=True))
    ocfg = OptimizerConfig(**(optimizer or {}))
    mask = trainable_mask(model, ocfg)
    partition_params(model, mask)
    params = {k: p for k, p in model.named_parameters()
              if mask[k] and not p.is_meta}
    opt = make_optimizer(params, ocfg)
    pipe = make_rank_pipe(n, dev)
    cuda = dev.type == "cuda"
    timer = StageTimer(cuda)
    step = make_pipelined_train_step(model, opt, pipe, microbatches, timer)
    whole = torch.load(batch, weights_only=False)
    local = batch_to_device(local_rows(whole, pipe), dev)
    held = sorted({int(k.split(".")[2]) for k, p in model.named_parameters()
                   if k.startswith("model.layers.") and not p.is_meta})
    meta = sorted({int(k.split(".")[2]) for k, p in model.named_parameters()
                   if k.startswith("model.layers.") and p.is_meta})
    for _ in range(warm_steps):
        step(local)
    mine = {"stage": pipe.stage, "replica": pipe.replica, "held": held,
            "meta": meta, "layers": list(layers), "transport": pipe.transport,
            "fingerprint": fingerprint(model), "steps": [],
            "stage_bytes": sum(p.numel() * p.element_size()
                               for k, p in params.items()
                               if LAYER_KEY.match(k))}
    metrics, first = [], None
    for _ in range(steps):
        dist.barrier()
        _kernels.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        timer.start()
        t0 = time.perf_counter()
        m = step(local)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        mine["steps"].append({
            "ms": ms, "marks": timer.read(),
            "launches": {k: v.launches for k, v in _kernels.KERNELS.items()
                         if v.launches},
            "peak": torch.cuda.max_memory_allocated() if cuda else None})
        metrics.append({k: float(v) for k, v in m.items()})
        if first is None and grads:
            first = {k: p.grad.detach().cpu().clone()
                     for k, p in params.items() if p.grad is not None}
    norm = float(opt.global_norm())
    mine["after"] = {"params": fingerprint(model),
                     "mu": bit_sums(opt.mu), "nu": bit_sums(opt.nu)}
    trained = None
    if grads:
        first = gather_stages(first, pipe, num_layers)
        trained = gather_stages({k: p.detach().cpu()
                                 for k, p in params.items()}, pipe,
                                num_layers)
    if val:
        ranked = RankPipelineModel(model, pipe, microbatches)
        with torch.inference_mode():
            boxes = ranked.forward_boxes(local)
            mine["val"] = {"boxes": {k: v.cpu() for k, v in boxes.items()},
                           "losses": {k: float(v) for k, v in
                                      ranked.forward_train(local).items()}}
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, mine)
    if rank == 0:
        torch.save({"ranks": got, "metrics": metrics, "norm": norm,
                    "grads": first, "params": trained}, out)


def driver(argv, dtype: Optional[str] = None, state_out: Optional[str] = None,
           device: str = "cuda") -> None:
    """`train.driver.main(argv)` in this rank's process group, the model in
    `dtype` ("fp32" or "bf16") where given instead of the size's
    (`driver.model_dtype`). With `state_out`, rank 0 writes there the
    whole state ({"params", "opt_state"}, every pipeline stage's gathered)
    as the first train step finds it: after `--auto_resume`, the state
    restored; every rank of a pipeline one stage a rank writes its own
    (its parameters with storage and its optimizer's state) to
    `state_out` + ".rank<r>"."""
    from ..checkpoint.manager import to_cpu
    from ..train import driver as drv
    from .pipeline import RankPipe, gather_stages
    if dtype is not None:
        drv.model_dtype = lambda size: DTYPES[dtype]
    real = drv.make_pipelined_train_step

    def spy(model, optimizer, pipe, *args, **kw):
        step, seen = real(model, optimizer, pipe, *args, **kw), []

        def first(batch):
            if state_out and not seen and isinstance(pipe, RankPipe):
                seen.append(True)
                n = model.cfg.llama.num_layers
                state = {"params": gather_stages(model.state_dict(), pipe, n),
                         "opt_state": gather_stages(optimizer.state_dict(),
                                                    pipe, n)}
                if pipe.rank == 0:
                    torch.save(to_cpu(state), state_out)
                own = {"params": {k: v for k, v in model.state_dict().items()
                                  if not v.is_meta},
                       "opt_state": optimizer.state_dict()}
                torch.save(to_cpu(own), f"{state_out}.rank{pipe.rank}")
            return step(batch)
        return first
    drv.make_pipelined_train_step = spy
    drv.main(list(argv))


WORKERS = {"train_step": train_step, "greedy": greedy,
           "pipeline_step": pipeline_step, "driver": driver}


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
