"""GPipe pipeline parallelism for the LLaMA decoder stack.

Counterpart of `grove_tpu/parallel/pipeline.py`. The JAX package stacks
the layers' parameters on a leading axis sharded over a "pipe" mesh axis
and runs the GPipe schedule in one `shard_map` program: at step t, stage k
runs microbatch t - k and hands its activation to stage k + 1 with
`ppermute`. Its pipe mesh is the first `n_stages` of `jax.devices()`,
which under `jax.distributed` span every process. The port has two
pipelines.

In one process, over a list of devices:

* `make_pipe_mesh(n_stages, devices)` names the stages' devices. Where
  JAX asserts `n_stages <= len(devices)`, the port takes an explicit list
  that may repeat a device: on one card every stage sits on `cuda:0`;
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
  `jax.checkpoint` on the layer body.

Across processes, one stage a rank (`RankPipe`, `make_rank_pipe`), in a
world of N x D ranks: D replicas of an N-stage pipeline, rank r replica
r // N and stage r % N (replica 0 is ranks 0..N-1). Stage k holds only
its layers (`stage_layers`; the others stay on the meta device,
`models.grove.init_grove_params(layers=)`) and the rest of the model
whole. Each rank holds its local batch; the global batch is their
concatenation in rank order, as JAX's under `--multihost`. JAX pipes
over the first N of `jax.devices()` and lays the global batch over
every device: its N stages run the whole global batch. Here each
replica runs its N ranks' rows through its own stages; every op but the
sums is per row, so the step is the same. A pass (`rank_forward`,
`rank_backward`), every message inside one replica:

1. each rank runs the encoders and the splice on its own rows;
2. the spliced rows go to the replica's stage 0, which splits the
   replica's rows into microbatches; stage k takes microbatch i from
   stage k - 1, runs its layers (under `torch.utils.checkpoint` with
   `remat`) and sends the result to stage k + 1;
3. the last stage sends each rank of the replica its rows of the output;
   each rank runs the final norm, `lm_head`, `ground` and the losses on
   them, with the global batch's normalizers (`parallel.mesh.
   count_reduce` over the world);
4. backward: each rank's d hidden goes to the replica's last stage, the
   stages run the microbatches' backward in reverse order (receive dy
   from k + 1, `torch.autograd.backward`, send dx to k - 1), and stage 0
   sends each rank the gradient of its spliced rows, which runs back
   through the splice and the encoders.

The messages are point-to-point (`dist.batch_isend_irecv`: every send is
posted with its receive): device tensors over NCCL; over gloo, whose
send and receive take CPU tensors only (the backend table of
`torch.distributed`), through pinned host buffers, the compute staying on
the card. The gradients of the replicated parameters are summed over the
world, those of stage k's layers over stage k's D ranks (`RankPipe.
stage_group`; with one replica, no sum), and the clipping norm sums each
stage's squares once over the replica (`RankPipe.pipe_group`, `train.
step.AdamW.sum_norm_over_`). A checkpoint gathers replica 0's stages'
layers and their optimizer state to rank 0 in the world-1 layout
(`gather_stages`). `RankPipelineModel` runs the driver's validation
through the same forward.

Scope, as in JAX: the cache-free (training, teacher-forced) pass.
"""

from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
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


# ---------------------------------------------------------------------------
# across processes: one stage a rank
# ---------------------------------------------------------------------------

LAYER_KEY = re.compile(r"^model\.layers\.(\d+)\.")


@dataclass(frozen=True)
class RankPipe:
    """A pipeline of one stage a rank, in `replicas` replicas: this rank is
    `stage` of `replica`, on `device`, global rank replica x n_stages +
    stage. `pipe_group` holds its replica's ranks (the world with one
    replica) and `stage_group` this stage's rank in every replica (None
    with one replica). Over gloo with CUDA tensors (`staged`) the
    messages travel through pinned host buffers."""
    n_stages: int
    stage: int
    device: torch.device
    backend: str
    replicas: int = 1
    replica: int = 0
    pipe_group: object = None
    stage_group: object = None

    @property
    def last(self) -> int:
        return self.n_stages - 1

    @property
    def rank(self) -> int:
        """This rank's index in the world: its shard of the data."""
        return self.peer(self.stage)

    @property
    def world(self) -> int:
        return self.replicas * self.n_stages

    def peer(self, stage: int) -> int:
        """The global rank of `stage` in this rank's replica."""
        return self.replica * self.n_stages + stage

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        return (f"{self.backend} through pinned host buffers" if self.staged
                else self.backend)


def make_rank_pipe(n_stages: int, device) -> RankPipe:
    """One stage a rank over the initialized world (`parallel.mesh.
    init_distributed`), which must hold `n_stages` processes or a multiple
    D of them: D replicas, rank r stage r % n_stages of replica
    r // n_stages; `device` is this rank's. Every rank calls it (a
    barrier: the first collective of the pipeline involves every rank),
    and with D > 1 every rank creates, in one order, the D pipe groups and
    then the `n_stages` stage groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_stages:
        raise ValueError(f"--pipeline_stages {n_stages} across processes "
                         f"runs one stage a rank: the world holds {world} "
                         f"processes, not {n_stages} or a multiple of "
                         f"{n_stages}")
    dist.barrier()
    replicas = world // n_stages
    replica, stage = divmod(dist.get_rank(), n_stages)
    pipe_group, stage_group = dist.group.WORLD, None
    if replicas > 1:
        pipes = [dist.new_group(list(range(d * n_stages,
                                           (d + 1) * n_stages)))
                 for d in range(replicas)]
        stages = [dist.new_group(list(range(k, world, n_stages)))
                  for k in range(n_stages)]
        pipe_group, stage_group = pipes[replica], stages[stage]
    return RankPipe(n_stages, stage, torch.device(device),
                    dist.get_backend(), replicas, replica, pipe_group,
                    stage_group)


def stage_layers(num_layers: int, n_stages: int, stage: int) -> range:
    """The decoder layers of `stage`: the k-th `num_layers / n_stages`."""
    per = num_layers // n_stages
    _stage_of(num_layers, n_stages)
    return range(stage * per, (stage + 1) * per)


def owned_by(name: str, num_layers: int, n_stages: int) -> Optional[int]:
    """The stage whose layer `name` (a parameter or state-dict key) belongs
    to, or None for the replicated rest."""
    m = LAYER_KEY.match(name)
    return None if m is None else int(m.group(1)) // (num_layers // n_stages)


def _post(pipe: RankPipe, sends=(), recvs=()):
    """Post every send [(tensor, dst)] and receive [(shape, dtype, src)]
    together; returns (works, the receive buffers, the buffers kept alive
    until the works complete)."""
    ops, keep, bufs = [], [], []
    for t, dst in sends:
        t = t.detach()
        if pipe.staged:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            t = h
        else:
            t = t.to(pipe.device).contiguous()
        keep.append(t)
        ops.append(dist.P2POp(dist.isend, t, dst))
    for shape, dtype, src in recvs:
        buf = (torch.empty(shape, dtype=dtype, pin_memory=True)
               if pipe.staged else
               torch.empty(shape, dtype=dtype, device=pipe.device))
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, src))
    works = dist.batch_isend_irecv(ops) if ops else []
    return works, bufs, keep


def _wait(pending) -> None:
    for works, _, _ in pending:
        for w in works:
            w.wait()


def _exchange(pipe: RankPipe, sends=(), recvs=()) -> List[torch.Tensor]:
    """`_post`, waited for; the received tensors on this rank's device."""
    posted = _post(pipe, sends, recvs)
    _wait([posted])
    return [b.to(pipe.device) for b in posted[1]]


def _mark(timer, kind: str, i: int):
    return contextlib.nullcontext() if timer is None else timer(kind, i)


def _run_stage(llama: nn.Module, x, positions, layers) -> torch.Tensor:
    from ..models.layers import remat_call
    for i in layers:
        x = remat_call(llama.remat, llama.layers[i], x, positions)
    return x


@dataclass
class _Flight:
    """What the backward of one pipelined pass needs on this rank."""
    x: torch.Tensor                     # its spliced rows, with their graph
    ins: List[torch.Tensor]             # its stage's microbatch inputs
    ys: List[torch.Tensor]              # its stage's microbatch outputs
    gathered: Optional[torch.Tensor]    # stage 0: the replica's rows
    h: torch.Tensor                     # its rows of the stack's output


def front(model: nn.Module, batch: Dict):
    """The encoders and the splice on a batch's rows: (spliced embeddings
    (B, S, D), SAM image embeddings)."""
    video_embeds, _ = model.encode_video(batch["frames_clip"])
    image_embeddings = model.encode_grounding(batch["frames_sam"],
                                              batch.get("sam_valid_hw"))
    x = model._splice(batch["input_ids"], video_embeds, batch["video_start"])
    return x, image_embeddings


def rank_forward(model: nn.Module, batch: Dict, pipe: RankPipe,
                 n_microbatches: int, timer=None):
    """Steps 1-3 of the module docstring on this rank's local `batch`:
    (post-final-norm hidden states of its rows, its SAM image embeddings,
    what `rank_backward` needs). With gradients on, the hidden states
    lead back to a leaf of the stack's output rows. Every rank calls it,
    with local batches of one size. `timer(kind, i)`, where given, is a
    context manager around each microbatch's work on this stage."""
    llama = model.model
    x, image_embeddings = front(model, batch)
    b, s, d = x.shape
    n, m, k = pipe.n_stages, n_microbatches, pipe.stage
    if (b * n) % m:
        raise ValueError(f"rank_forward: a replica's {n} x {b} rows do "
                         f"not divide into {m} microbatches")
    grad = torch.is_grad_enabled()
    positions = torch.arange(s, device=x.device)
    layers = stage_layers(len(llama.layers), n, k)
    gathered, ins = None, []
    if k == 0:
        got = _exchange(pipe, recvs=[((b, s, d), x.dtype, pipe.peer(r))
                                     for r in range(1, n)])
        gathered = torch.cat([x.detach()] + got)
        if grad:
            gathered.requires_grad_()
        ins = list(gathered.chunk(m))
    else:
        _exchange(pipe, sends=[(x, pipe.peer(0))])
    ys, pending = [], []
    rows = b * n // m
    for i in range(m):
        if k > 0:
            xi = _exchange(pipe, recvs=[((rows, s, d), x.dtype,
                                         pipe.peer(k - 1))])[0]
            ins.append(xi.requires_grad_() if grad else xi)
        with _mark(timer, "forward", i):
            ys.append(_run_stage(llama, ins[i], positions, layers))
        if k < n - 1:
            pending.append(_post(pipe, sends=[(ys[i], pipe.peer(k + 1))]))
    _wait(pending)
    if k == pipe.last:
        out = torch.cat([y.detach() for y in ys])
        _exchange(pipe, sends=[(out[r * b:(r + 1) * b], pipe.peer(r))
                               for r in range(n - 1)])
        h = out[k * b:(k + 1) * b].clone()
    else:
        h = _exchange(pipe, recvs=[((b, s, d), x.dtype,
                                    pipe.peer(pipe.last))])[0]
    if grad:
        h.requires_grad_()
    flight = _Flight(x, ins, ys, gathered, h)
    return llama.norm(h), image_embeddings, flight


def rank_backward(flight: _Flight, pipe: RankPipe, n_microbatches: int,
                  timer=None) -> None:
    """Step 4 of the module docstring, once this rank's loss has run its
    backward into `flight.h`: the stack's backward over the stages in
    reverse microbatch order, then the splice's and the encoders' on each
    rank. Every rank calls it."""
    n, m, k = pipe.n_stages, n_microbatches, pipe.stage
    dh = flight.h.grad
    if dh is None:
        dh = torch.zeros_like(flight.h)
    if k == pipe.last:
        got = _exchange(pipe, recvs=[(dh.shape, dh.dtype, pipe.peer(r))
                                     for r in range(n - 1)])
        douts = list(torch.cat(got + [dh]).chunk(m))
    else:
        _exchange(pipe, sends=[(dh, pipe.peer(pipe.last))])
    pending = []
    for i in reversed(range(m)):
        y = flight.ys[i]
        dy = (douts[i] if k == pipe.last else
              _exchange(pipe, recvs=[(y.shape, y.dtype,
                                      pipe.peer(k + 1))])[0])
        with _mark(timer, "backward", i):
            torch.autograd.backward(y, dy)
        if k > 0:
            pending.append(_post(pipe, sends=[(flight.ins[i].grad,
                                               pipe.peer(k - 1))]))
    _wait(pending)
    x = flight.x
    b = x.shape[0]
    if k == 0:
        dx = flight.gathered.grad
        _exchange(pipe, sends=[(dx[r * b:(r + 1) * b], pipe.peer(r))
                               for r in range(1, n)])
        dx = dx[:b]
    else:
        dx = _exchange(pipe, recvs=[(x.shape, x.dtype, pipe.peer(0))])[0]
    if x.requires_grad:
        x.backward(dx)


def local_rows(batch: Dict, pipe: RankPipe) -> Dict:
    """This rank's rows of a global batch (every rank holding the same):
    the r-th of the world's equal parts of each entry's leading dim, r
    this rank's place in the world (`RankPipe.rank`)."""
    out = {}
    for key, v in batch.items():
        b = len(v) // pipe.world
        out[key] = v[pipe.rank * b:(pipe.rank + 1) * b]
    return out


class RankPipelineModel:
    """`forward_train` and `forward_boxes` of a GroveModel pipelined one
    stage a rank, for the driver's `validate`: each takes this rank's
    local batch (the ranks' batches of one size, as the sharded loader
    gives them) and returns its rows' result, the losses with this
    batch's own normalizers, as `validate` takes them on every process of
    the JAX package and of data parallelism; the microbatches are as many
    of `n_microbatches` as divide the replica's rows."""

    def __init__(self, model: nn.Module, pipe: RankPipe,
                 n_microbatches: int):
        self.model, self.pipe, self.m = model, pipe, n_microbatches

    def _forward(self, batch: Dict):
        rows = len(batch["input_ids"]) * self.pipe.n_stages   # a replica's
        return rank_forward(self.model, batch, self.pipe,
                            math.gcd(self.m, rows))

    def forward_train(self, batch: Dict) -> Dict[str, torch.Tensor]:
        hidden, image_embeddings, _ = self._forward(batch)
        out = self.model.losses(batch, hidden, self.model.lm_head(hidden),
                                image_embeddings)
        return {k: v for k, v in out.items() if k.endswith("loss")}

    def forward_boxes(self, batch: Dict) -> Dict[str, torch.Tensor]:
        hidden, image_embeddings, _ = self._forward(batch)
        boxes, obj = self.model.ground(hidden, batch["det_positions"],
                                       image_embeddings)
        return {"pred_boxes": boxes, "objectness_logits": obj}


# ---------------------------------------------------------------------------
# whole tensors of a pipelined model: every stage's layers on rank 0
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _stage_entry(path, num_layers: int, pipe: RankPipe) -> bool:
    return any(isinstance(key, str)
               and owned_by(key, num_layers, pipe.n_stages) == pipe.stage
               for key in path)


def _put(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def gather_stages(tree, pipe: RankPipe, num_layers: int):
    """On rank 0, `tree` (a state dict, or an optimizer's state: nests of
    dicts whose keys name parameters) with every other stage's entries for
    its own decoder layers filled in (a meta tensor replaced) or added, as
    whole CPU tensors: the world-1 layout. On the other ranks None. Every
    rank calls it; each stage of replica 0 sends rank 0 a list of its
    entries, then the tensors one at a time; the other replicas, whose
    copies are equal, send nothing."""
    if pipe.replica != 0:
        return None
    mine = [(path, t) for path, t in _leaves(tree)
            if isinstance(t, torch.Tensor) and not t.is_meta
            and _stage_entry(path, num_layers, pipe)]
    if pipe.stage != 0:
        dist.send_object_list([[(p, tuple(t.shape), t.dtype)
                                for p, t in mine]], dst=pipe.peer(0))
        for _, t in mine:
            _exchange(pipe, sends=[(t, pipe.peer(0))])
        return None
    out = {}
    for path, t in _leaves(tree):
        _put(out, path, t)
    for src in range(1, pipe.n_stages):
        header = [None]
        dist.recv_object_list(header, src=pipe.peer(src))
        for path, shape, dtype in header[0]:
            t = _exchange(pipe, recvs=[(shape, dtype, pipe.peer(src))])[0]
            _put(out, path, t.cpu())
    meta = [path for path, t in _leaves(out)
            if isinstance(t, torch.Tensor) and t.is_meta]
    if meta:
        raise RuntimeError(f"gather_stages: no stage sent {meta[:4]}")
    return out


def local_entries(tree, like):
    """The entries of `tree` (a whole state, as `gather_stages` gives)
    that `like` (this rank's own state of the same form) has."""
    if isinstance(like, dict):
        return {k: local_entries(tree[k], v) for k, v in like.items()}
    return tree
