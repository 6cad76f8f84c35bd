"""Fused LLaMA projections: q/k/v -> qkv_proj, gate/up -> gate_up_proj.

Counterpart of `grove_tpu/models/fuse.py`, on the port's state-dict names.
The output columns of a matmul are independent dot products, so joining
the kernels along the output axis is a pure layout transform; each output
channel keeps its scale, and each group column of an int4 scale its
column. The leaves it joins:

* float `nn.Linear`: `weight` (N, K), the output axis first;
* `Int8Linear`: `kernel_q` (K, N) and the per-channel `scale` (N,);
* `Int4Linear`: `kernel_q4p` (K/2, N) and the group `scale` (K/G, N).

As in the JAX package, an attention module is fused only beside an
`o_proj` and an MLP only beside a `down_proj`, so CLIP's q/k/v/out_proj
stay as they are. `fuse_llama_` rebuilds a model's decoder layers IN PLACE
with `fused_qkv=True`, one layer at a time.

The JAX package calls fusion bit-identical. On the card the port's K7a and
K7b choose their split of K from the number of column tiles
(`ops/int4_matmul.py:_split`), which the fused width changes, so a fused
projection may sum in another order than the three it replaces: fused and
unfused agree there to a tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Sequence

import torch
from torch import nn

_FUSIONS = (("qkv_proj", ("q_proj", "k_proj", "v_proj"), "o_proj"),
            ("gate_up_proj", ("gate_proj", "up_proj"), "down_proj"))


def _out_axis(leaf: str, t: torch.Tensor) -> int:
    """The output axis of a projection's leaf: first for an `nn.Linear`
    weight, last for the quantized kernels and scales."""
    return 0 if leaf == "weight" else t.dim() - 1


def _by_module(sd: Dict[str, torch.Tensor]):
    """{parent path: {child name: {leaf: tensor}}} for keys parent.child.leaf
    (parent "" for a key child.leaf)."""
    tree = defaultdict(lambda: defaultdict(dict))
    for key, t in sd.items():
        parts = key.rsplit(".", 2)
        parent = parts[0] if len(parts) == 3 else ""
        tree[parent][parts[-2]][parts[-1]] = t
    return tree


def _join(parent: str, child: str, leaf: str) -> str:
    return f"{parent}.{child}.{leaf}" if parent else f"{child}.{leaf}"


def _concat(parts: Sequence[Dict[str, torch.Tensor]]) -> Dict:
    leaves = set(parts[0])
    if any(set(p) != leaves for p in parts):
        raise ValueError(f"mismatched projection leaves: "
                         f"{[sorted(p) for p in parts]}")
    return {leaf: torch.cat([p[leaf] for p in parts],
                            dim=_out_axis(leaf, parts[0][leaf]))
            for leaf in leaves}


def fuse_llama_projections(sd: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """A state dict with every LLaMA attention's q/k/v_proj replaced by
    `qkv_proj` and every MLP's gate/up_proj by `gate_up_proj`
    (`fuse.py:58-89`); other keys pass through. Idempotent."""
    out = dict(sd)
    for parent, children in _by_module(sd).items():
        for fused, names, sibling in _FUSIONS:
            if not set(names) | {sibling} <= set(children):
                continue
            for leaf, t in _concat([children[n] for n in names]).items():
                out[_join(parent, fused, leaf)] = t
            for n in names:
                for leaf in children[n]:
                    del out[_join(parent, n, leaf)]
    return out


def unfuse_llama_projections(sd: Dict[str, torch.Tensor], cfg
                             ) -> Dict[str, torch.Tensor]:
    """The inverse of `fuse_llama_projections` (`fuse.py:92-131`); `cfg`
    is the LlamaConfig, whose head counts and MLP width set the split
    points."""
    hd = cfg.head_dim
    sizes = {"qkv_proj": (cfg.num_heads * hd, cfg.num_kv_heads * hd,
                          cfg.num_kv_heads * hd),
             "gate_up_proj": (cfg.intermediate_size,) * 2}
    out = dict(sd)
    for parent, children in _by_module(sd).items():
        for fused, names, _ in _FUSIONS:
            if fused not in children:
                continue
            for leaf, t in children[fused].items():
                del out[_join(parent, fused, leaf)]
                pieces = torch.split(t, sizes[fused], _out_axis(leaf, t))
                for n, piece in zip(names, pieces):
                    out[_join(parent, n, leaf)] = piece
    return out


@torch.no_grad()
def fuse_llama_(model: nn.Module) -> nn.Module:
    """Fuse a `models.grove.GroveModel`'s LLaMA projections IN PLACE
    (`GroveForCausalLM.fuse`, `api/model.py:174-188`): each decoder layer
    is rebuilt with `fused_qkv=True` from its own fused state dict, float
    or quantized, and `model.cfg` updated. W8A8 `kernel_q`s are laid out
    column-major again after the join. A no-op on a fused model."""
    from ..ops.int8_matmul import column_major
    from .layers import Int8Linear
    from .llama import LlamaDecoderLayer, set_llama_cfg_
    cfg = model.cfg
    if cfg.llama.fused_qkv:
        return model
    llama = dataclasses.replace(cfg.llama, fused_qkv=True)
    layers: List[nn.Module] = model.model.layers
    for i, layer in enumerate(layers):
        new = LlamaDecoderLayer(llama, device="meta",
                                dtype=layer.input_layernorm.weight.dtype)
        new.load_state_dict(fuse_llama_projections(layer.state_dict()),
                            strict=True, assign=True)
        for mod in new.modules():
            if isinstance(mod, Int8Linear) and mod.act_quant:
                mod.kernel_q = column_major(mod.kernel_q)
        layers[i] = new.train(layer.training)
    set_llama_cfg_(model.model, llama)
    model.cfg = dataclasses.replace(cfg, llama=llama)
    return model
