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
for every other key. A SAM built on another grid (the reference trains SAM
at 1024, a 64 x 64 grid) is resized to the model's, as the JAX converter
resizes it (`torch_convert.py:56-73`, `:359-363`): `pos_embed` bicubic,
the `rel_pos_*` tables linearly, with `jax.image.resize`'s weights
(`models.grove._resize_weights`, the antialias of a downscale included).
Every other shape mismatch raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..models.grove import _resize_weights

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


_POS_EMBED = re.compile(r"^model\.grounding_encoder\.image_encoder\."
                        r"pos_embed$")
_REL_POS = re.compile(r"^model\.grounding_encoder\.image_encoder\.blocks\."
                      r"(\d+)\.attn\.rel_pos_[hw]$")


def _resize_axes(x: torch.Tensor, sizes, method: str) -> torch.Tensor:
    """`jax.image.resize(x, sizes, method)` in fp32 for a resize along the
    leading axes (the trailing one kept): one weight matrix per axis whose
    size changes, applied as a dense product, as XLA computes it."""
    out = x.float()
    for axis, size in enumerate(sizes):
        if out.shape[axis] == size:
            continue
        w = _resize_weights(out.shape[axis], size, method, out.device)
        out = torch.tensordot(out.movedim(axis, -1), w, dims=1).movedim(
            -1, axis)
    return out


def resize_sam_grids(tensors: Mapping[str, torch.Tensor],
                     cfg) -> Dict[str, torch.Tensor]:
    """The SAM tables of a checkpoint on another grid, resized to `cfg`'s
    as the JAX converter does (`torch_convert.py:56-73`, `:359-363`):
    `pos_embed` (1, g0, g0, C) or (g0, g0, C) bicubic to (1, g, g, C) where
    g0 != g = `cfg.sam_enc.grid`; a block's `rel_pos_h` / `rel_pos_w`
    (L0, hd) linearly to L = 2 span - 1 rows where L0 != L, span the grid
    in the global blocks and `window_size` in the others. Other keys pass
    unchanged."""
    enc = cfg.sam_enc
    out = dict(tensors)
    for key, val in tensors.items():
        if _POS_EMBED.match(key):
            pos = val[0] if val.dim() == 4 else val
            if pos.shape[0] != enc.grid:
                out[key] = _resize_axes(pos, (enc.grid, enc.grid),
                                        "bicubic")[None]
            continue
        m = _REL_POS.match(key)
        if m:
            span = (enc.grid if int(m[1]) in enc.global_attn_indexes
                    else enc.window_size)
            if val.shape[0] != 2 * span - 1:
                out[key] = _resize_axes(val, (2 * span - 1,), "bilinear")
    return out


def load_reference_state_dict(model: nn.Module,
                              sd: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy `sd` (reference torch names -> numpy arrays or tensors) into
    `model`, strictly: keys matching `SKIP_PATTERNS` are dropped, SAM's
    tables on another grid are resized to the model's (`resize_sam_grids`,
    for a model with a `cfg`), and then a missing key, an unexpected key or
    a shape mismatch raises. Values are cast to each parameter's dtype and
    device by the copy."""
    tensors: Dict[str, torch.Tensor] = {
        k: _tensor(v) for k, v in sd.items() if not _SKIP.search(k)}
    cfg = getattr(model, "cfg", None)
    if cfg is not None:
        tensors = resize_sam_grids(tensors, cfg)
    model.load_state_dict(tensors, strict=True)
    return model


_QUANT_LEAF = re.compile(
    r"^llama/layers_(\d+)/(self_attn|mlp)/"
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj|qkv_proj|"
    r"gate_up_proj)/"
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


_LORA_LEAF = re.compile(
    r"^llama/layers_(\d+)/self_attn/((?:q|v)_proj_lora)/(lora_[AB])/kernel$")


def jax_lora_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The LoRA leaves of a JAX GroveModel parameter tree (numpy or jax,
    float or after a quantizing transform, which leaves them float) under
    the port's names: the Dense kernel `llama/layers_N/self_attn/
    q_proj_lora/lora_A/kernel`, (in, r), becomes the (r, in) weight
    `model.layers.N.self_attn.q_proj_lora.lora_A.weight`; lora_B's (r, out)
    kernel the (out, r) weight; v_proj_lora likewise. The JAX exporter
    `to_torch_state_dict` writes no LoRA names, so a float model loads
    `{**to_torch_state_dict(params), **jax_lora_state_dict(params)}`
    strictly, and `load_jax_quantized_llama` carries these leaves too."""
    out = {}
    for path, leaf in _flatten(params):
        m = _LORA_LEAF.match(path)
        if m:
            out[f"model.layers.{m[1]}.self_attn.{m[2]}.{m[3]}.weight"] = \
                torch.from_numpy(np.array(leaf)).t().contiguous()
        elif "_lora/" in path:
            raise KeyError(f"jax_lora_state_dict: LoRA leaf {path} has no "
                           "counterpart in the port")
    return out


@torch.no_grad()
def load_jax_quantized_llama(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy the quantized LLM leaves of a JAX GroveModel parameter tree
    (after `quantize_llama_tree_int4` or `quantize_llama_tree`, fused by
    `fuse_llama_projections` or not: numpy or jax `kernel_q4p`,
    `kernel_q`, `scale`) into the `Int4Linear` / `Int8Linear` buffers of a
    quantized port model of the same options (`act_quant`, `fused_qkv`),
    by path: `llama/layers_N/self_attn/q_proj` (or `qkv_proj`) ->
    `model.layers.N.self_attn.q_proj`, `lm_head/lm_head` -> `lm_head`.
    Strict: every quantized leaf of the tree lands in a buffer of the same
    shape and dtype, and every quantized buffer of the model is written.
    The tree's LoRA leaves (`jax_lora_state_dict`) land in the model's
    LoRA weights, strictly both ways too.
    The copy keeps each buffer's layout (a W8A8 `kernel_q` stays
    column-major). Other leaves are left to `load_reference_state_dict`."""
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
    lora = jax_lora_state_dict(params)
    mine = {n: p for n, p in model.named_parameters() if "_lora." in n}
    if set(lora) != set(mine):
        raise KeyError(f"load_jax_quantized_llama: LoRA leaves "
                       f"{sorted(set(lora) ^ set(mine))[:4]} on one side only")
    for name, src in lora.items():
        if src.shape != mine[name].shape:
            raise ValueError(f"load_jax_quantized_llama: {name} is "
                             f"{tuple(src.shape)} in the tree, "
                             f"{tuple(mine[name].shape)} in the model")
        mine[name].copy_(src)
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
