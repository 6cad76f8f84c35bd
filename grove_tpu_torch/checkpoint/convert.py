"""Load a reference-named state dict into `models.grove.GroveModel`, and
carry the JAX package's quantized LLM and tower leaves across.

The port's module tree carries the reference torch names
(`model.vision_tower.vision_tower.vision_model.*`, `model.layers.N.*`,
`model.grounding_encoder.*`, `lm_head.weight`, ...), so a state dict in that
namespace loads with `strict=True` and no key mapping: the dict that
`grove_tpu/checkpoint/torch_convert.py:to_torch_state_dict` exports from a
JAX parameter tree, or a reference checkpoint. Reference checkpoints also
carry two key families no module of the model uses; they are dropped by the
JAX converter's own patterns (`SKIP_PATTERNS`) and the load stays strict
for every other key.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# copy of grove_tpu/checkpoint/torch_convert.py:330-333 (that module imports
# jax); tests/test_torch_misc.py holds the two equal
SKIP_PATTERNS = (
    r"vision_model\.post_layernorm",
    r"rotary_emb\.inv_freq",
)
_SKIP = re.compile("|".join(SKIP_PATTERNS))


def _tensor(v) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v)))


def load_reference_state_dict(model: nn.Module,
                              sd: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy `sd` (reference torch names -> numpy arrays or tensors) into
    `model`, strictly: keys matching `SKIP_PATTERNS` are dropped, and then
    a missing key, an unexpected key or a shape mismatch raises. Values are
    cast to each parameter's dtype and device by the copy."""
    tensors: Dict[str, torch.Tensor] = {
        k: _tensor(v) for k, v in sd.items() if not _SKIP.search(k)}
    model.load_state_dict(tensors, strict=True)
    return model


_QUANT_LEAF = re.compile(
    r"^llama/layers_(\d+)/(self_attn|mlp)/"
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)/"
    r"(kernel_q4p|kernel_q|scale)$")
_LM_HEAD_LEAF = re.compile(r"^lm_head/lm_head/(kernel_q|scale)$")
_QUANT_BUFFERS = ("kernel_q4p", "kernel_q", "scale")


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


@torch.no_grad()
def load_jax_quantized_llama(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy the quantized LLM leaves of a JAX GroveModel parameter tree
    (after `quantize_llama_tree_int4` or `quantize_llama_tree`: numpy or
    jax `kernel_q4p`, `kernel_q`, `scale`) into the `Int4Linear` /
    `Int8Linear` buffers of a quantized port model, by path:
    `llama/layers_N/self_attn/q_proj` -> `model.layers.N.self_attn.q_proj`,
    `lm_head/lm_head` -> `lm_head`. Strict: every quantized leaf of the
    tree lands in a buffer of the same shape and dtype, and every quantized
    buffer of the model is written. Other leaves are left to
    `load_reference_state_dict`."""
    targets = {name: buf for name, buf in model.named_buffers()
               if name.rsplit(".", 1)[-1] in _QUANT_BUFFERS
               and name.startswith(("model.layers.", "lm_head."))}
    written = set()
    for path, leaf in _flatten(params):
        m = _QUANT_LEAF.match(path)
        if m:
            name = f"model.layers.{m[1]}.{m[2]}.{m[3]}.{m[4]}"
        elif _LM_HEAD_LEAF.match(path):
            name = f"lm_head.{path.rsplit('/', 1)[-1]}"
        elif (path.startswith(("llama/", "lm_head/"))
              and path.rsplit("/", 1)[-1] in _QUANT_BUFFERS):
            raise KeyError(f"load_jax_quantized_llama: quantized leaf {path} "
                           "has no counterpart in the port")
        else:
            continue
        if name not in targets:
            raise KeyError(f"load_jax_quantized_llama: {path} has no buffer "
                           f"{name} in the model")
        src = torch.from_numpy(np.array(leaf))
        dst = targets[name]
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"load_jax_quantized_llama: {path} is "
                             f"{src.dtype}{tuple(src.shape)}, {name} is "
                             f"{dst.dtype}{tuple(dst.shape)}")
        dst.copy_(src)
        written.add(name)
    missing = sorted(set(targets) - written)
    if missing:
        raise KeyError(f"load_jax_quantized_llama: no leaf for {missing[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")
    return model


_TOWER_LEAVES = ("kernel_q", "scale", "act_scale", "proj_act_scale")


@torch.no_grad()
def load_jax_quantized_towers(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy the quantized tower leaves of a JAX GroveModel parameter tree
    (after `quantize_clip_tree` / `quantize_sam_tree` and
    `install_act_scales`: `kernel_q`, `scale`, `act_scale`,
    `proj_act_scale` under `vision_tower/` and `grounding_encoder/`) into
    the buffers of a port model whose towers are W8A8
    (`ops.quant.quantize_vision_`), by path: `vision_tower/layers_N/fc2`
    -> `...vision_model.encoder.layers.N.mlp.fc2`,
    `grounding_encoder/blocks_N/attn` -> `...image_encoder.blocks.N.attn`
    (`ops.quant.jax_site_path`). Strict: every such leaf lands in a buffer
    of the same shape and dtype, and every such buffer of the towers is
    written. Float leaves (norms, biases, rel-pos tables) are unchanged by
    quantization and load through `load_reference_state_dict`."""
    from ..ops.quant import jax_site_path, vision_towers
    targets = {}
    for key, tower in vision_towers(model).items():
        for name, buf in tower.named_buffers():
            mod, leaf = name.rsplit(".", 1)
            if leaf in _TOWER_LEAVES:
                path = (f"{key}/{jax_site_path(mod, key == 'vision_tower')}"
                        f"/{leaf}")
                targets[path] = (name, buf)
    flat = dict(_flatten(params))
    # a `scale` is quantized only beside a kernel_q (LayerNorm gammas are
    # `scale` too)
    quantized = {p.rsplit("/", 1)[0] for p in flat if p.endswith("/kernel_q")}
    written = set()
    for path, leaf in flat.items():
        parent, name = path.rsplit("/", 1)
        if (not path.startswith(("vision_tower/", "grounding_encoder/"))
                or name not in _TOWER_LEAVES
                or (name == "scale" and parent not in quantized)):
            continue
        if path not in targets:
            raise KeyError(f"load_jax_quantized_towers: quantized leaf {path}"
                           " has no buffer in the model")
        name, dst = targets[path]
        src = torch.from_numpy(np.array(leaf))
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"load_jax_quantized_towers: {path} is "
                             f"{src.dtype}{tuple(src.shape)}, {name} is "
                             f"{dst.dtype}{tuple(dst.shape)}")
        dst.copy_(src)
        written.add(path)
    missing = sorted(set(targets) - written)
    if missing:
        raise KeyError(f"load_jax_quantized_towers: no leaf for "
                       f"{missing[:4]}{' ...' if len(missing) > 4 else ''}")
    return model
