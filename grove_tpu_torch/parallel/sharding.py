"""Partition rules: Megatron-style tensor parallelism for the LLaMA and the
towers' MLPs, ZeRO-2 optimizer state, FSDP and sequence parallelism.

Counterpart of `grove_tpu/parallel/sharding.py`. The rules match the
port's parameter names, which are the reference's (the JAX tree's names
map onto them through `grove_tpu/checkpoint/torch_convert.py:77-330`), and
name the torch dims: a `Linear.weight` is (out, in) where a flax `kernel`
is (in, out), so JAX's `P(None, "model")` on q/k/v, gate/up, `lin1` and
`fc1` is dim 0 here (`Shard(0)`), `P("model", None)` on o/down, `lin2`
and `fc2` dim 1, `lm_head`'s (D, V) kernel is the (V, D) weight's dim 0,
and `embed_tokens` (V, D) keeps dim 0. A spec is a tuple of one mesh
axis name (or None) per tensor dim, as JAX's `PartitionSpec`;
`placements` turns it into the DTensor placements over ("data",
"model"). The fused q/k/v and gate/up projections and the quantized
buffers (`kernel_q`, `kernel_q4p`) match no rule and stay replicated, as
in JAX.

`shard_pytree` applies them to a `GroveModel` with PyTorch's own
machinery (`torch.distributed.tensor.parallel`, FSDP2 `fully_shard`):

* tensor parallelism over "model": `ColwiseParallel` on a linear whose
  rule shards dim 0 (`lm_head` with its logits gathered), `RowwiseParallel`
  on dim 1 and on a vocab-sharded `Embedding`. Each rank's projections
  hand the attention its `num_heads / tp` heads as plain tensors, so the
  kernels take no DTensor. A column-parallel linear's bias is sharded with
  its weight (`ColwiseParallel`), where JAX leaves it replicated and slices
  it at use: the same numbers;
* sequence parallelism (`GroveModel(llm_act_sharding=mesh)`): the LLaMA's
  cache-free residual stream sharded on S over "model"
  (`models.llama.LlamaModel.act_sharding`);
* FSDP over "data" (`fsdp=True`): one `fully_shard` group over the whole
  model, each parameter sharded on the dim `fsdp_shardings` gives it
  (`shard_placement_fn`); the parameters it leaves replicated are left
  out of FSDP (`ignored_params`) and their gradients summed over "data"
  by `parallel.mesh.sync_gradients`, which also turns FSDP's mean of the
  gradients back into their sum (times the "data" size: exact for a power
  of two), for the global normalizers of `parallel.mesh`. gloo has no
  pre-multiplied sum to make FSDP's reduction a sum itself.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from .mesh import AXES

Spec = Tuple[Optional[str], ...]

# (regex on the parameter name, spec over the torch dims) — first match wins
LLAMA_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    # attention: shard heads (output features of q/k/v, input of o)
    (r"^model\.layers\.\d+\.self_attn\.(q|k|v)_proj\.weight$",
     ("model", None)),
    (r"^model\.layers\.\d+\.self_attn\.o_proj\.weight$", (None, "model")),
    # mlp: shard the intermediate dim
    (r"^model\.layers\.\d+\.mlp\.(gate|up)_proj\.weight$", ("model", None)),
    (r"^model\.layers\.\d+\.mlp\.down_proj\.weight$", (None, "model")),
    # embeddings / head: shard the vocabulary
    (r"^model\.embed_tokens\.weight$", ("model", None)),
    (r"^lm_head\.weight$", ("model", None)),
    # vision towers: shard the MLP features
    (r"\.image_encoder\.blocks\.\d+\.mlp\.lin1\.weight$", ("model", None)),
    (r"\.image_encoder\.blocks\.\d+\.mlp\.lin2\.weight$", (None, "model")),
    (r"\.encoder\.layers\.\d+\.mlp\.fc1\.weight$", ("model", None)),
    (r"\.encoder\.layers\.\d+\.mlp\.fc2\.weight$", (None, "model")),
)


def mesh_shape(mesh) -> Dict[str, int]:
    """{"data": n, "model": m} of a `DeviceMesh` (or of such a mapping,
    which lets the rules run without a process group)."""
    if isinstance(mesh, Mapping):
        return {ax: int(mesh.get(ax, 1)) for ax in AXES}
    return {ax: mesh.size(i) for i, ax in enumerate(mesh.mesh_dim_names)}


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    """name -> shape of a module's parameters, or of a name -> tensor or
    shape mapping."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {n: tuple(v.shape) if hasattr(v, "shape") else tuple(v)
            for n, v in params.items()}


def _jax_orders(params) -> Dict[str, Tuple[int, ...]]:
    """name -> for each torch dim, its position in the JAX kernel's layout
    (`torch_convert.py`: a Linear (out, in) is flax (in, out), a Conv
    (out, in, *k) is (*k, in, out), a ConvTranspose (in, out, *k) is
    (*k, in, out); SAM's `pos_embed` has a leading 1 flax drops, -1 here);
    other tensors keep their order. `zero_sharding` shards the dim that is
    flax's dim 0, and `fsdp_shardings` breaks ties between equal dims as
    JAX does, on the JAX order."""
    if not isinstance(params, nn.Module):
        return {}
    out = {}
    for name, p in params.named_parameters():
        if name.endswith(".pos_embed") and p.ndim == 4 and p.shape[0] == 1:
            # SAM's (1, g, g, C) is flax's (g, g, C)
            out[name] = (-1, 0, 1, 2)
    for mname, mod in params.named_modules():
        w = getattr(mod, "weight", None)
        if not isinstance(w, nn.Parameter) or w.ndim < 2:
            continue
        n = w.ndim
        if isinstance(mod, nn.Linear):
            order = (1, 0)
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            order = (n - 1, n - 2) + tuple(range(n - 2))
        elif isinstance(mod, nn.ConvTranspose2d):
            order = (n - 2, n - 1) + tuple(range(n - 2))
        else:
            continue
        out[f"{mname}.weight" if mname else "weight"] = order
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def partition_spec_for(name: str, shape: Sequence[int],
                       rules=LLAMA_TP_RULES, mesh=None) -> Spec:
    """The first rule's spec for `name` (`sharding.py:52`); () when none
    matches, or when a mesh axis of the spec does not divide its dim
    (`:60-66`)."""
    for pat, spec in rules:
        if re.search(pat, name):
            if len(spec) > len(shape):
                continue
            if mesh is not None:
                sizes = mesh_shape(mesh)
                if not all(ax is None or shape[i] % sizes[ax] == 0
                           for i, ax in enumerate(spec)):
                    return ()
            return spec
    return ()


def placements(spec: Spec, mesh=None) -> Tuple:
    """A spec as DTensor placements over the ("data", "model") axes:
    Shard(dim) for the axis the spec names at dim, else Replicate."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in AXES:
        dims = [i for i, a in enumerate(spec) if a == ax]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def params_shardings(params, mesh, rules=LLAMA_TP_RULES) -> Dict[str, Tuple]:
    """name -> (data, model) placements of every parameter (`:69`)."""
    return {n: placements(partition_spec_for(n, s, rules, mesh))
            for n, s in _shapes(params).items()}


def zero_sharding(params, mesh, rules=LLAMA_TP_RULES) -> Dict[str, Tuple]:
    """Optimizer-state placements (`:77`, ZeRO-2): a parameter no rule
    shards gets its moments' first dim in the JAX layout (`_jax_orders`:
    a Linear weight's dim 1, the flax kernel's dim 0) over "data" where
    "data" divides it; a tensor-parallel parameter keeps its own
    placements (its spec taken without the divisibility check, as
    JAX's)."""
    ndata = mesh_shape(mesh)["data"]
    orders = _jax_orders(params)
    out = {}
    for n, shape in _shapes(params).items():
        spec = partition_spec_for(n, shape, rules)
        if spec == () and len(shape) >= 1:
            d = orders.get(n, tuple(range(len(shape)))).index(0)
            if shape[d] % ndata == 0 and shape[d] >= ndata:
                spec = (None,) * d + ("data",)
        out[n] = placements(spec)
    return out


def _fsdp_spec(name: str, shape, mesh, rules=LLAMA_TP_RULES,
              axis: str = "data", min_size: int = 1 << 14,
              order: Optional[Sequence[int]] = None) -> Spec:
    """`fsdp_shardings`' spec of one parameter: its tensor-parallel spec,
    plus `axis` on its largest dim that the spec leaves unsharded and
    `axis` divides, where it has at least `min_size` elements; of equal
    dims the last in the JAX layout (`order`, see `_jax_orders`)."""
    ndata = mesh_shape(mesh)[axis]
    order = order or tuple(range(len(shape)))
    spec = list(partition_spec_for(name, shape, rules, mesh))
    spec += [None] * (len(shape) - len(spec))
    if _numel(shape) >= min_size and ndata > 1:
        cands = [(shape[i], order[i], i) for i in range(len(shape))
                 if spec[i] is None and shape[i] % ndata == 0
                 and shape[i] >= ndata]
        if cands:
            spec[max(cands)[2]] = axis
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def fsdp_shardings(params, mesh, rules=LLAMA_TP_RULES, axis: str = "data",
                   min_size: int = 1 << 14) -> Dict[str, Tuple]:
    """ZeRO-3-style fully sharded parameters (`:92`): every parameter of at
    least `min_size` elements also sharded over `axis` on its largest
    tensor-parallel-unsharded dim that `axis` divides."""
    orders = _jax_orders(params)
    return {n: placements(_fsdp_spec(n, s, mesh, rules, axis, min_size,
                                    orders.get(n)))
            for n, s in _shapes(params).items()}


def sequence_parallel_sharding(mesh) -> Tuple:
    """(data, model) placements of the (B, S, D) residual stream under
    sequence parallelism (`:118`): B over "data", S over "model"."""
    from torch.distributed.tensor import Shard
    return (Shard(0), Shard(1))


# ---------------------------------------------------------------------------
# applying the placements
# ---------------------------------------------------------------------------

def _tp_plan(model: nn.Module, mesh, rules=LLAMA_TP_RULES) -> Dict:
    """module name -> `ParallelStyle` of every module whose weight a rule
    shards over "model" (and "model" divides)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel)
    plan = {}
    for name, mod in model.named_modules():
        w = getattr(mod, "weight", None)
        if not isinstance(w, nn.Parameter):
            continue
        spec = partition_spec_for(f"{name}.weight", tuple(w.shape), rules,
                                  mesh)
        if "model" not in spec:
            continue
        dim = spec.index("model")
        if isinstance(mod, nn.Embedding) and dim == 0:
            # the token ids are the same on every rank
            plan[name] = RowwiseParallel(input_layouts=Replicate())
        elif isinstance(mod, nn.Linear) and dim == 0:
            plan[name] = (ColwiseParallel(output_layouts=Replicate())
                          if name == "lm_head" else ColwiseParallel())
        elif isinstance(mod, nn.Linear) and dim == 1:
            plan[name] = RowwiseParallel()
        else:
            raise ValueError(f"shard_pytree: no tensor-parallel style for "
                             f"{type(mod).__name__} {name} on dim {dim}")
    return plan


def shard_pytree(model: nn.Module, mesh, *, fsdp: bool = False,
                 min_size: int = 1 << 14, rules=LLAMA_TP_RULES
                 ) -> nn.Module:
    """Apply the placements to a `GroveModel` in place (`:127`): the
    tensor-parallel plans over "model" where its size is above 1, sequence
    parallelism where the model has `llm_act_sharding`, and with `fsdp`
    FSDP2 over "data" where its size is above 1 (see the module
    docstring). Set `requires_grad` (`train.step.partition_params`) first,
    and take the trainable parameters by name after: the sharded ones are
    new `Parameter`s."""
    sizes = mesh_shape(mesh)
    tp = sizes["model"]
    if tp > 1:
        from torch.distributed.tensor.parallel import parallelize_module
        cfg = model.cfg.llama
        if cfg.num_heads % tp or cfg.num_kv_heads % tp:
            raise ValueError(f"shard_pytree: {cfg.num_heads} heads / "
                             f"{cfg.num_kv_heads} kv heads do not divide "
                             f"over model = {tp}")
        tp_mesh = mesh["model"]
        parallelize_module(model, tp_mesh, _tp_plan(model, mesh, rules))
        rank = mesh.get_local_rank("model")
        for layer in model.model.layers:
            layer.self_attn.tp = (rank, tp)
        model.model.tp_size = tp
        if model.llm_act_sharding is not None:
            model.model.act_sharding = tp_mesh
    if fsdp and sizes["data"] > 1:
        _fully_shard(model, mesh, rules, min_size)
    return model


def _fully_shard(model, mesh, rules, min_size):
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard
    dims, ignored = {}, set()
    orders = _jax_orders(model)
    for name, p in model.named_parameters():
        spec = _fsdp_spec(name, tuple(p.shape), mesh, rules, "data", min_size,
                         orders.get(name))
        if "data" in spec:
            dims[id(p)] = spec.index("data")
        else:
            ignored.add(p)
    fully_shard(model, mesh=mesh["data"], ignored_params=ignored,
                shard_placement_fn=lambda p: Shard(dims[id(p)]))
    register_fsdp_forward_method(model, "forward_train")


# ---------------------------------------------------------------------------
# whole tensors of a sharded model
# ---------------------------------------------------------------------------

def full_state_dict(tree):
    """A state dict (or any nest of dicts) with every DTensor gathered into
    its whole tensor (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full_state_dict(v) for k, v in tree.items()}
    return tree


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]
                         ) -> None:
    """`model.load_state_dict(state, strict=True)` for whole tensors, a
    DTensor parameter or buffer taking its own shard of each."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    own = model.state_dict()
    missing = set(own) ^ set(state)
    if missing:
        raise KeyError(f"load_full_state_dict: keys differ: "
                       f"{sorted(missing)[:4]}")
    for name, t in own.items():
        src = state[name]
        if isinstance(t, DTensor):
            src = distribute_tensor(src.to(t.device_mesh.device_type),
                                    t.device_mesh, t.placements).to_local()
            t = t.to_local()
        t.copy_(src)
