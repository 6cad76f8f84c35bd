"""Training step: freeze policy, AdamW, the step function.

Counterpart of `grove_tpu/train/step.py`. The recipe is the reference's
DeepSpeed config (`train.py:466-487`): AdamW, lr 5e-5, betas (0.9, 0.95),
WarmupDecayLR (linear warmup over `warmup_steps`, linear decay to 0 at
`total_steps`), gradient clipping at global norm 1.0.

* Freeze policy (`prepare_model_for_training`, `train.py:234-334`):
  everything frozen except both towers' video adapters, the box and
  objectness heads (the whole mask decoder with `train_mask_decoder`),
  `text_hidden_fcs`, `mm_projector`, `lm_head` and `embed_tokens`.
  `trainable_mask` gives the JAX package's set over the port's (reference)
  parameter names; `partition_params` sets `requires_grad` from it, which
  is what the JAX package's trainable / frozen trees do there. Quantized
  modules are never trainable.
* `AdamW` is optax's `chain(clip_by_global_norm, adamw)`, written out:
  the global norm over the trainable parameters only; moments
  mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu kept in the
  parameter's dtype (optax with `mu_dtype=None`); bias correction with the
  incremented count; eps added outside the square root; decoupled weight
  decay, scaled by the learning rate; and the learning rate of the step
  *before* the increment, so step 0 takes lr(0), which is 0 under warmup.
  A trainable parameter that got no gradient (the CLIP adapters behind
  the tower's no-grad) takes a zero one, as optax sees zeros there.
  `torch.optim.AdamW` rounds differently, so it is not used.
* `moment_dtype="bf16"` gives `train.lowmem.adamw_bf16` instead (the
  QLoRA recipe: bf16 moments, and with `lowmem.apply_updates_sr`
  stochastic rounding of bf16 parameters). LoRA adapters (`_lora`) are
  trainable, as in JAX (`step.py:37`).
* `MultiSteps` is `optax.MultiSteps` (the driver's
  `--grad_accumulation_steps`, `grove_tpu/train/driver.py:325-328`): the
  gradients of k micro-batches are averaged (Welford's running mean, as
  optax's), and the wrapped optimizer's update runs on the k-th only, so
  its `count`, and with it the schedule, advances once per update.
* `state_dict` / `load_state_dict` carry the optimizer's state (the count
  and the moments; for `MultiSteps` also its step counters and the
  accumulated gradients) through `checkpoint.manager`.
* Parallel training (`parallel/`): a parameter may be a DTensor (tensor
  parallelism, FSDP2). `AdamW` then keeps each moment as the parameter's
  local shard and updates the shard in place (Adam is elementwise), and
  `global_norm` is the norm over the whole gradients: each leaf's local
  sum of squares summed over the mesh dims it is sharded on.
  `AdamW.shard_state_` gives replicated parameters ZeRO-2 moments
  (`parallel.sharding.zero_sharding`): each data rank updates its slice,
  and the slices are gathered into the parameter.
  `make_train_step(mesh=)` runs the data-parallel step with JAX's global
  normalizers (`parallel.mesh`); `make_pipelined_train_step` is the
  GPipe step of `step.py:165-223` (`parallel.pipeline`), in one process
  or one stage a rank.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

TRAINABLE_PATTERNS_FINETUNE = (
    r"\.adapters\.\d+\.",                          # both towers' adapters
    r"\.mask_decoder\.bbox_prediction_head\.",
    r"\.mask_decoder\.temporal_objectness_head\.",
    r"\.text_hidden_fcs\.",
    r"\.mm_projector\.",
    r"^lm_head\.",
    r"\.embed_tokens\.",
    r"_lora",                                      # LoRA on q/v
)
EMBEDDINGS = (r"^lm_head\.", r"\.embed_tokens\.")
MASK_DECODER = r"\.mask_decoder\."
FULL_LLM = r"^model\.(layers|norm)\."            # the JAX tree's `llama/`
QUANTIZED_BUFFERS = ("kernel_q", "kernel_q4p")
EPS = 1e-8                  # Adam's eps, added outside the square root
_LAYER_LEAF = re.compile(r"^(.*?\.)(\d+)\.(.*)$")   # prefix, layer, rest


@dataclasses.dataclass
class OptimizerConfig:
    lr: float = 5e-5
    betas: Tuple[float, float] = (0.9, 0.95)
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 7000
    grad_clip: float = 1.0
    train_mask_decoder: bool = True
    full_llm: bool = False
    freeze: bool = True
    # the reference trains lm_head and embed_tokens (`train.py:300-311`)
    train_embeddings: bool = True
    # "f32" (optax's default: moments in the parameter's dtype) or "bf16"
    # (`train.lowmem.adamw_bf16`: bf16 moments for the single-card
    # fine-tune)
    moment_dtype: str = "f32"


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule at `count`."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def warmup_decay_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """DeepSpeed WarmupDecayLR as the JAX package builds it from optax:
    linear 0 -> lr over `warmup_steps`, then lr -> 0 over the rest."""
    decay = max(cfg.total_steps - cfg.warmup_steps, 1)

    def lr(count: int) -> float:
        if count < cfg.warmup_steps:
            return _linear(0.0, cfg.lr, cfg.warmup_steps, count)
        return _linear(cfg.lr, 0.0, decay, count - cfg.warmup_steps)
    return lr


def trainable_mask(model: nn.Module, cfg: OptimizerConfig) -> Dict[str,
                                                                   bool]:
    """name -> trainable for every parameter of a GroveModel: the set of
    the JAX package's `trainable_mask` over the reference names."""
    pats = list(TRAINABLE_PATTERNS_FINETUNE)
    if not cfg.train_embeddings:
        pats = [p for p in pats if p not in EMBEDDINGS]
    if cfg.train_mask_decoder:
        pats.append(MASK_DECODER)
    if cfg.full_llm:
        pats.append(FULL_LLM)
    regex = re.compile("|".join(pats))
    quantized = {name for name, mod in model.named_modules()
                 if any(hasattr(mod, b) for b in QUANTIZED_BUFFERS)}
    mask = {}
    for name, p in model.named_parameters():
        owner = name.rsplit(".", 1)[0] if "." in name else ""
        mask[name] = (owner not in quantized and p.is_floating_point()
                      and (not cfg.freeze or bool(regex.search(name))))
    return mask


def partition_params(model: nn.Module, mask: Dict[str, bool]
                     ) -> Dict[str, nn.Parameter]:
    """Set `requires_grad` from `mask`; return the trainable parameters by
    name. Frozen parameters get no gradient and no optimizer state."""
    trainable = {}
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable[name] = p
    return trainable


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _reduced_dims(placements) -> Tuple[int, ...]:
    """The mesh dims over which a DTensor's local sums add up to the whole
    (sharded or partial ones; a replicated dim holds copies)."""
    from torch.distributed.tensor import Replicate
    return tuple(i for i, pl in enumerate(placements)
                 if not isinstance(pl, Replicate))


class AdamW:
    """`optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay=...))` over `params` (name -> parameter), written out
    (see the module docstring); `grad_clip=None` leaves out the clip.
    `update()` returns the updates by name and leaves the parameters alone;
    `step()` adds them in place (optax's `apply_updates`: the sum in the
    parameter's dtype). `lowmem.AdamWBf16` changes only how the moments are
    stored and updated and how the clipping norm is summed. For a DTensor
    parameter the moments, the updates and the add are this rank's local
    shard; `shard_state_` makes a replicated parameter's moments ZeRO-2
    shards."""

    def __init__(self, params: Dict[str, nn.Parameter], schedule, *,
                 b1: float = 0.9, b2: float = 0.999, weight_decay: float = 0.0,
                 grad_clip: Optional[float] = None):
        self.params = dict(params)
        self.schedule = schedule
        self.b1, self.b2 = b1, b2
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.count = 0
        self.zero: Dict[str, Tuple] = {}
        self.stage_norm = None
        self.mu = {n: self._zeros(_local(p)) for n, p in self.params.items()}
        self.nu = {n: self._zeros(_local(p)) for n, p in self.params.items()}

    @staticmethod
    def _zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(p)

    def shard_state_(self, mesh, placements: Dict[str, Tuple]) -> None:
        """ZeRO-2 (`parallel.sharding.zero_sharding`): each plain
        (replicated) parameter whose placements shard a dim over "data"
        keeps its moments as this data rank's slice of that dim."""
        from torch.distributed.tensor import Shard
        data = mesh.mesh_dim_names.index("data")
        size, rank = mesh.size(data), mesh.get_local_rank("data")
        for name, pl in placements.items():
            p = self.params.get(name)
            if (p is None or _is_dtensor(p) or size == 1
                    or not isinstance(pl[data], Shard)):
                continue
            dim = pl[data].dim
            n = p.shape[dim] // size
            self.zero[name] = (mesh, tuple(pl), dim, rank * n, n)
            self.mu[name] = self._zeros(p.detach().narrow(dim, 0, n))
            self.nu[name] = self._zeros(p.detach().narrow(dim, 0, n))

    def sum_norm_over_(self, names, num_layers: int, group) -> None:
        """Pipeline stages (`parallel.pipeline`): the gradients of `names`
        (`<prefix><layer>.<rest>`, this rank's stage's of `num_layers`
        layers) are this rank's alone. Their per-leaf sums of squares are
        laid into one vector by layer and summed over `group` (a
        pipeline's ranks, each calling), then taken in the one-process
        order with each leaf's dtype, so that each leaf's rounding is the
        one-process norm's; the other gradients are equal on every rank of
        `group` and count once."""
        self.stage_norm = (frozenset(names), num_layers, group)

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def _local_grad(self, name: str, p) -> Optional[torch.Tensor]:
        """The gradient of `name` as this rank holds it in the parameter's
        own placements (a partial or other layout redistributed first)."""
        g = p.grad
        if g is None or not _is_dtensor(g):
            return g
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        return g.to_local()

    def _leaf_sq_sums(self, square) -> list:
        """[(sum of square(g) over the whole gradient, fp32, 0-dim), g's
        dtype] of each trainable gradient: a DTensor's local sum summed
        over the mesh dims it is sharded on (one all-reduce per mesh and
        dims); with `sum_norm_over_`, every stage's layers
        (`_all_stages`)."""
        out, pending, staged = [], {}, {}
        for name, p in self.params.items():
            if p.grad is None:
                continue
            g = self._local_grad(name, p)
            s = square(g).sum()
            if self.stage_norm is not None and name in self.stage_norm[0]:
                staged[name] = len(out)
            dims = _reduced_dims(p.placements) if _is_dtensor(p) else ()
            if dims:
                pending.setdefault((id(p.device_mesh), dims),
                                   (p.device_mesh, dims, []))[2].append(
                                       len(out))
            out.append([s, g.dtype])
        for mesh, dims, idx in pending.values():
            vec = torch.stack([out[i][0] for i in idx])
            for d in dims:
                dist.all_reduce(vec, group=mesh.get_group(d))
            for i, v in zip(idx, vec.unbind()):
                out[i][0] = v
        if staged:
            out = self._all_stages(out, staged)
        return out

    def _all_stages(self, out: list, staged: Dict[str, int]) -> list:
        """`out` with this stage's layer entries (`staged`: name -> index)
        replaced, where the first of them stood, by every layer's of every
        stage: a vector of num_layers x (leaves a layer) sums, each rank
        filling its layers' slots, summed over the group."""
        _, num_layers, group = self.stage_norm
        parts = {n: _LAYER_LEAF.match(n).groups() for n in staged}
        rests = list(dict.fromkeys(rest for _, _, rest in parts.values()))
        dtypes = {rest: out[staged[n]][1] for n, (_, _, rest)
                  in parts.items()}
        first = min(staged.values())
        vec = torch.zeros(num_layers * len(rests),
                          device=out[first][0].device)
        for n, (_, layer, rest) in parts.items():
            vec[int(layer) * len(rests) + rests.index(rest)] = \
                out[staged[n]][0].float()
        dist.all_reduce(vec, group=group)
        every = [[v, dtypes[rests[i % len(rests)]]]
                 for i, v in enumerate(vec.unbind())]
        skip = set(staged.values())
        return ([e for i, e in enumerate(out[:first]) if i not in skip]
                + every
                + [e for i, e in enumerate(out) if i > first
                   and i not in skip])

    @torch.no_grad()
    def global_norm(self) -> torch.Tensor:
        """fp32 global norm of the trainable gradients (0-dim, on the
        parameters' device: no host sync)."""
        sq = [s for s, _ in self._leaf_sq_sums(lambda g: g.float().pow(2))]
        return torch.stack(sq).sum().sqrt() if sq else torch.zeros(())

    def _bias_corrections(self, count: int) -> Tuple[float, float]:
        return 1 - self.b1 ** count, 1 - self.b2 ** count

    def _adam(self, name: str, g: torch.Tensor, bc1: float,
              bc2: float) -> torch.Tensor:
        """Advance `name`'s moments by g; its bias-corrected Adam step."""
        mu, nu = self.mu[name], self.nu[name]
        mu.copy_((1 - self.b1) * g + self.b1 * mu)
        nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
        return (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)

    def _slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a parameter-shaped local tensor: its ZeRO
        slice, or all of it."""
        if name not in self.zero:
            return t
        _, _, dim, start, n = self.zero[name]
        return t.narrow(dim, start, n)

    def _updates(self):
        """(name, update of this rank's part) of one step, one parameter at
        a time; the count advances once all are taken."""
        clip_at = self.grad_clip
        if clip_at is not None:
            norm = self.global_norm()
            clip = norm >= clip_at
        count = self.count + 1
        bc1, bc2 = self._bias_corrections(count)
        lr = self.schedule(self.count)
        for name, p in self.params.items():
            pl = self._slice(name, _local(p))
            g = self._local_grad(name, p)
            g = self._slice(name, g) if g is not None else torch.zeros_like(
                pl)
            if clip_at is not None:
                g = torch.where(clip, (g / norm.to(g.dtype)) * clip_at, g)
            u = self._adam(name, g, bc1, bc2)
            if self.weight_decay:
                u = u + self.weight_decay * pl
            yield name, u * -lr
        self.count = count

    @torch.no_grad()
    def update(self) -> Dict[str, torch.Tensor]:
        """One step's updates by name (of each parameter's local part);
        advances the moments and the count."""
        return dict(self._updates())

    def _layout(self, name: str):
        """(mesh, placements) of a sharded parameter's moments, or None."""
        if name in self.zero:
            return self.zero[name][:2]
        p = self.params[name]
        return (p.device_mesh, tuple(p.placements)) if _is_dtensor(p) \
            else None

    def state_dict(self) -> Dict:
        """{"count", "mu", "nu"}: the moments by parameter name, the live
        tensors (`checkpoint.manager` copies them off); a sharded moment as
        a DTensor of the parameter's shape, which the manager gathers."""
        from torch.distributed.tensor import DTensor

        def wrap(name, t):
            layout = self._layout(name)
            if layout is None:
                return t
            p = self.params[name]
            return DTensor.from_local(t, layout[0], layout[1],
                                      run_check=False, shape=p.shape,
                                      stride=p.stride())
        return {"count": self.count,
                "mu": {n: wrap(n, t) for n, t in self.mu.items()},
                "nu": {n: wrap(n, t) for n, t in self.nu.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a `state_dict()` into this optimizer's tensors (their
        device and dtype stay); the names and shapes must match. Whole
        moments of a sharded parameter are cut to this rank's shard."""
        for key in ("mu", "nu"):
            src = {}
            for name, t in state[key].items():
                layout = self._layout(name) if name in self.params else None
                src[name] = (_local_piece(t, *layout) if layout is not None
                             else t)
            _copy_tensors(getattr(self, key), src, key)
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self) -> None:
        """`update()` and a plain add, p <- (p + u) in p's dtype, each
        parameter as soon as its update is made (a ZeRO slice is added,
        then the data ranks' slices are gathered into the parameter)."""
        from torch.distributed.tensor import DTensor
        for name, u in self._updates():
            p = _local(self.params[name])
            part = self._slice(name, p)
            new = part + u
            if name in self.zero:
                mesh, pl = self.zero[name][:2]
                p.copy_(DTensor.from_local(
                    new.contiguous(), mesh, pl, run_check=False,
                    shape=p.shape, stride=p.stride()).full_tensor())
            else:
                part.copy_(new)


def _local(p: torch.Tensor) -> torch.Tensor:
    """A parameter's local tensor (the DTensor's shard, or itself)."""
    return p.to_local() if _is_dtensor(p) else p


def _copy_tensors(dst: Dict[str, torch.Tensor], src: Dict, what: str):
    if set(dst) != set(src):
        raise ValueError(f"load_state_dict: {what} names differ: "
                         f"{sorted(set(dst) ^ set(src))[:4]}")
    for name, t in dst.items():
        if tuple(t.shape) != tuple(src[name].shape):
            raise ValueError(f"load_state_dict: {what}[{name}] is "
                             f"{tuple(src[name].shape)}, not "
                             f"{tuple(t.shape)}")
        t.copy_(src[name])


def _local_piece(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard, under `placements` on `mesh`, of `t` (a whole
    tensor, or a DTensor whose local shard is taken as it is)."""
    from torch.distributed.tensor import distribute_tensor
    if _is_dtensor(t):
        return t.to_local()
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    return distribute_tensor(t.to(device), mesh, list(placements)).to_local()


class MultiSteps:
    """`optax.MultiSteps(optimizer, every_k)` with the default mean
    (`use_grad_mean=True`): each `step()` folds the parameters' gradients
    into a running mean, acc += (g - acc) / (mini_step + 1) in the
    parameter's dtype, and on every k-th it hands that mean to the wrapped
    optimizer as the gradient, takes its step and zeroes the mean. The
    other steps leave the parameters and the wrapped optimizer alone."""

    def __init__(self, optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"MultiSteps: every_k {every_k} < 1")
        self.opt = optimizer
        self.every_k = every_k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return self.opt.params

    @property
    def count(self) -> int:
        return self.opt.count

    def zero_grad(self) -> None:
        self.opt.zero_grad()

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for name, p in self.params.items():
            acc = self.acc[name]
            g = p.grad if p.grad is not None else torch.zeros_like(acc)
            acc.copy_(acc + (g - acc) / (n + 1))
        self.zero_grad()
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step:
            return
        for name, p in self.params.items():
            p.grad = self.acc[name]
        self.opt.step()
        self.zero_grad()
        for acc in self.acc.values():
            acc.zero_()
        self.gradient_step += 1

    def state_dict(self) -> Dict:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "inner_opt_state": self.opt.state_dict(),
                "acc_grads": dict(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.opt.load_state_dict(state["inner_opt_state"])
        _copy_tensors(self.acc, state["acc_grads"], "acc_grads")
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])


def make_optimizer(params: Dict[str, nn.Parameter], cfg: OptimizerConfig):
    """AdamW over the trainable parameters only (state is never allocated
    for frozen ones): `AdamW` for `moment_dtype="f32"`, `lowmem.adamw_bf16`
    for "bf16" (`step.py:122-133`)."""
    from .lowmem import adamw_bf16
    kw = dict(b1=cfg.betas[0], b2=cfg.betas[1], weight_decay=cfg.weight_decay,
              grad_clip=cfg.grad_clip)
    if cfg.moment_dtype == "bf16":
        return adamw_bf16(params, warmup_decay_schedule(cfg), **kw)
    if cfg.moment_dtype != "f32":
        raise ValueError(f"OptimizerConfig.moment_dtype "
                         f"{cfg.moment_dtype!r}: expected 'f32' or 'bf16'")
    return AdamW(params, warmup_decay_schedule(cfg), **kw)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict:
    """A `data.collate.build_batch` batch as tensors on `device`
    (`video_start` stays host-side: the splice reads it there)."""
    return {k: v if k == "video_start" else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


def make_train_step(model: nn.Module, optimizer, mesh=None):
    """train_step(batch) -> the loss dict (detached): forward_train,
    backward, clip, update. Gradients exist only for the parameters that
    `partition_params` left trainable.

    With a ("data", "model") `mesh` (`parallel.mesh.make_mesh`) the batch
    is this rank's local batch: the loss counts are summed over "data"
    before they divide, the gradients summed over "data" where FSDP does
    not reduce them, and the returned terms are the global batch's
    (`parallel.mesh`): the step of the global batch, as JAX's SPMD
    step."""
    from ..parallel import mesh as pmesh
    reduce = pmesh.count_reduce(mesh)

    def train_step(batch):
        optimizer.zero_grad()
        out = (model.forward_train(batch) if reduce is None
               else model.forward_train(batch, count_reduce=reduce))
        out["loss"].backward()
        pmesh.sync_gradients(optimizer.params, mesh)
        optimizer.step()
        return pmesh.reduce_metrics({k: v.detach() for k, v in out.items()},
                                    mesh)
    return train_step


def row_at_a_time(model: nn.Module, host_batch: Dict[str, np.ndarray]):
    """The step of `host_batch` computed as the pipeline's ranks compute
    it, one row at a time: each row's loss with the whole batch's
    normalizers (each count summed over the rows, as `count_reduce` sums
    it over the ranks), its backward, the gradients of the default
    trainable set summed in their dtype. Returns (the summed loss
    terms, the gradients by name). No weight moves."""
    params = partition_params(model, trainable_mask(
        model, OptimizerConfig(warmup_steps=1)))
    rows = [batch_to_device({k: v[r:r + 1] for k, v in host_batch.items()},
                            model.device)
            for r in range(len(host_batch["labels"]))]
    counts = []
    with torch.no_grad():
        for b in rows:
            seen = []
            model.forward_train(b, count_reduce=lambda c: seen.append(
                c.detach().clone()) or c)
            counts.append(seen)
    totals = [sum(c) for c in zip(*counts)]
    terms, grads = {}, {}
    for b in rows:
        left = iter(totals)
        for p in params.values():
            p.grad = None
        out = model.forward_train(b, count_reduce=lambda c: next(left))
        out["loss"].backward()
        for k, v in out.items():
            terms[k] = terms.get(k, 0.0) + float(v.detach())
        for n, p in params.items():
            if p.grad is not None:
                grads[n] = (p.grad.detach().clone() if n not in grads
                            else grads[n] + p.grad)
        del out
    for p in params.values():
        p.grad = None
    return terms, grads


def make_eval_step(model: nn.Module):
    @torch.no_grad()
    def eval_step(batch):
        return model.forward_train(batch)
    return eval_step


def make_pipelined_train_step(model: nn.Module, optimizer, pipe,
                              n_microbatches: int, timer=None):
    """The train step with the LLaMA decoder stack GPipe-pipelined
    (`step.py:165-223`), in microbatches of the batch's rows /
    n_microbatches; the same loss and gradients as `make_train_step` on
    that batch. Equal-length packed prompts (the collator's), and
    num_layers divisible by the stages.

    * `pipe` a `parallel.pipeline.PipeMesh` (one process): the encoders,
      the splice, the final norm, `lm_head`, `ground` and the losses run
      on stage 0's device, as `make_train_step` runs them; only the
      decoder layers run in the schedule, each on its stage's device
      (`parallel.pipeline.place_stages`).
    * `pipe` a `parallel.pipeline.RankPipe` (one stage a rank, JAX's step
      under `--multihost`; D replicas of the pipeline in a world of N x D):
      the batch is this rank's local batch, and the step is the global
      batch's (the ranks' local batches in rank order): each rank runs
      the encoders, the splice, the heads and the losses on its rows with
      the global normalizers, each replica's stages run its ranks' rows
      through the stack in `n_microbatches` microbatches (`parallel.
      pipeline.rank_forward` / `rank_backward`; JAX splits the global
      batch instead, the same math: every op but the sums is per row),
      the gradients of the replicated parameters are summed over the
      world and those of stage k's layers over stage k's ranks
      (`RankPipe.stage_group`, timed as "stage_sum" by `timer`), the
      clipping norm counts each stage's once over the replica
      (`AdamW.sum_norm_over_` on `RankPipe.pipe_group`: after the sums
      every replica holds the same gradients), and the returned terms are
      the global batch's. `timer` as `rank_forward`'s.
    """
    from ..parallel.pipeline import RankPipe, pipelined_llama_forward
    if isinstance(pipe, RankPipe):
        return _rank_pipelined_step(model, optimizer, pipe, n_microbatches,
                                    timer)

    def loss_fn(batch):
        video_embeds, _ = model.encode_video(batch["frames_clip"])
        image_embeddings = model.encode_grounding(batch["frames_sam"],
                                                  batch.get("sam_valid_hw"))
        x = model._splice(batch["input_ids"], video_embeds,
                          batch["video_start"])
        positions = torch.arange(x.shape[1], device=x.device)
        hidden = pipelined_llama_forward(model.model, x, positions, pipe,
                                         n_microbatches)
        return model.losses(batch, hidden, model.lm_head(hidden),
                            image_embeddings)

    def train_step(batch):
        optimizer.zero_grad()
        out = loss_fn(batch)
        out["loss"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in out.items()}
    return train_step


def _rank_pipelined_step(model, optimizer, pipe, n_microbatches, timer):
    from ..parallel import mesh as pmesh
    from ..parallel.pipeline import (LAYER_KEY, _mark, rank_backward,
                                     rank_forward)
    world = dist.group.WORLD
    staged = {n for n in optimizer.params if LAYER_KEY.match(n)}
    getattr(optimizer, "opt", optimizer).sum_norm_over_(
        staged, len(model.model.layers), pipe.pipe_group)
    shared = {n: p for n, p in optimizer.params.items() if n not in staged}
    layers = {n: p for n, p in optimizer.params.items() if n in staged}
    reduce = pmesh.count_reduce(None, world)

    def train_step(batch):
        optimizer.zero_grad()
        hidden, image_embeddings, flight = rank_forward(
            model, batch, pipe, n_microbatches, timer)
        out = model.losses(batch, hidden, model.lm_head(hidden),
                           image_embeddings, reduce)
        out["loss"].backward()
        rank_backward(flight, pipe, n_microbatches, timer)
        pmesh.sync_gradients(shared, None, world)
        if pipe.stage_group is not None:
            with _mark(timer, "stage_sum", 0):
                pmesh.sync_gradients(layers, None, pipe.stage_group)
        optimizer.step()
        return pmesh.reduce_metrics({k: v.detach() for k, v in out.items()},
                                    None, world)
    return train_step
