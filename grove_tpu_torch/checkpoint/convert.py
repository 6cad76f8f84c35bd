"""Load a reference-named state dict into `models.grove.GroveModel`, carry
the JAX package's quantized LLM and tower leaves across, and read and
write the JAX package's whole parameter tree (`load_jax_tree`,
`jax_tree_from_model`).

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
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models.grove import _resize_weights
# the JAX converter's patterns (`torch_convert.py:330-333`, copied there);
# tests/test_torch_misc.py holds the two equal
from .torch_convert import (SKIP_PATTERNS, convert_state_dict,
                            to_torch_state_dict)

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


# ---------------------------------------------------------------------------
# the JAX package's whole parameter tree <-> the port's state dict
# ---------------------------------------------------------------------------

# the mask decoder's transposed convolutions: flax's ConvTranspose does not
# flip its kernel as torch's does, so the converter's layout of a JAX
# kernel computes the JAX package's masks in the port only flipped in both
# spatial axes; the reader flips, the writer flips back (a reference `.bin`
# carries torch's own kernels and loads unflipped)
_UPSCALING = re.compile(r"^model\.grounding_encoder\.mask_decoder\."
                        r"output_upscaling\.[03]\.weight$")
# a fused LLaMA projection is laid out as its first part
_FUSED_PARTS = {"qkv_proj": "q_proj", "gate_up_proj": "gate_proj"}
_FUSED_PATH = re.compile(r"^(llama/layers_\d+/(?:self_attn|mlp)/)"
                         r"(qkv_proj|gate_up_proj)(/kernel)$")
_FUSED_NAME = re.compile(r"^(model\.layers\.\d+\.(?:self_attn|mlp)\.)"
                         r"(qkv_proj|gate_up_proj)(\.weight)$")
_QUANT_NAME = re.compile(r"^model\.layers\.(\d+)\.(self_attn|mlp)\.(\w+_proj)"
                         r"\.(kernel_q4p|kernel_q|scale)$")
_LM_HEAD_NAME = re.compile(r"^lm_head\.(kernel_q|scale)$")
_LORA_NAME = re.compile(r"^model\.layers\.(\d+)\.self_attn\."
                        r"((?:q|v)_proj_lora)\.(lora_[AB])\.weight$")
# the towers' JAX tree keys, their module prefixes in the port, and whether
# the tower is CLIP's (`ops.quant.jax_site_path`)
_TOWERS = {"vision_tower": ("model.vision_tower.vision_tower.vision_model.",
                            True),
           "grounding_encoder": ("model.grounding_encoder.image_encoder.",
                                 False)}
_ACT_SCALES = ("act_scale", "proj_act_scale")
_PROBE = (2, 3, 5, 7, 11)      # distinct sizes, so a probe's axes tell apart


def _nest(flat: Mapping[str, object]) -> Dict:
    """{"a/b/c": v} -> {"a": {"b": {"c": v}}}."""
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _probe(ndim: int) -> np.ndarray:
    dims = _PROBE[:ndim]
    return np.arange(int(np.prod(dims))).reshape(dims)


def _read_layout(path: str, ndim: int):
    """(port name, axis order, leading unit axes) of the copied
    `to_torch_state_dict` for a leaf of `ndim` axes at `path`, or None
    where it has no rule. Learned from an index array whose axes have
    distinct sizes, and checked to be a pure layout, so that the tensor
    itself is permuted where it lies (on the card for a load there)."""
    probe = _probe(ndim)
    out = to_torch_state_dict(_nest({path: probe}), None)
    if not out:
        return None
    (name, arr), = out.items()
    lead = arr.ndim - ndim
    body = arr.shape[max(lead, 0):]
    order = tuple(probe.shape.index(d) if d in probe.shape else -1
                  for d in body)
    if (lead < 0 or arr.shape[:lead] != (1,) * lead
            or sorted(order) != list(range(ndim))
            or not np.array_equal(arr.reshape(body), probe.transpose(order))):
        raise ValueError(f"{path}: the converter's transform is not a "
                         "layout")
    return name, order, lead


def _tower_module(site: str, clip: bool) -> str:
    """The inverse of `ops.quant.jax_site_path`: a JAX module path inside a
    tower -> the port's (`layers_3/fc2` -> `encoder.layers.3.mlp.fc2`)."""
    from ..ops.quant import jax_site_path
    p = re.sub(r"\b(layers|blocks|adapters)_(\d+)", r"\1.\2",
               site.replace("/", "."))
    if clip:
        p = re.sub(r"^(layers\.\d+)\.(fc[12])\b", r"\1.mlp.\2", p)
        p = re.sub(r"^(adapters\.\d+)\.adapter\.", r"\1.", p)
        if p.startswith(("layers.", "adapters.")):
            p = "encoder." + p
    if jax_site_path(p, clip) != site:
        raise ValueError(f"{site}: no module of the port's tower")
    return p


def _port_entry(path: str, ndim: int):
    """(port name, axis order, leading unit axes) of the JAX leaf at
    `path`; ValueError where the port has no place for it."""
    m = _FUSED_PATH.match(path)
    if m:
        name, order, lead = _read_layout(
            f"{m[1]}{_FUSED_PARTS[m[2]]}{m[3]}", ndim)
        return name.replace(_FUSED_PARTS[m[2]], m[2]), order, lead
    entry = _read_layout(path, ndim)
    if entry is not None:
        return entry
    ident = tuple(range(ndim))
    m = _QUANT_LEAF.match(path)
    if m:
        return f"model.layers.{m[1]}.{m[2]}.{m[3]}.{m[4]}", ident, 0
    if _LM_HEAD_LEAF.match(path):
        return f"lm_head.{path.rsplit('/', 1)[-1]}", ident, 0
    m = _LORA_LEAF.match(path)
    if m and ndim == 2:
        return (f"model.layers.{m[1]}.self_attn.{m[2]}.{m[3]}.weight",
                (1, 0), 0)
    key, _, rest = path.partition("/")
    site, _, leaf = rest.rpartition("/")
    if key in _TOWERS and leaf in _TOWER_LEAVES and site:
        prefix, clip = _TOWERS[key]
        return f"{prefix}{_tower_module(site, clip)}.{leaf}", ident, 0
    raise ValueError(f"{path}: no tensor of the port takes this leaf")


def _leaf_tensor(leaf) -> torch.Tensor:
    """A tree leaf as a CPU tensor over the same memory where it can be
    (a read-only array is copied; bf16 arrays of the `bfloat16` numpy
    type that JAX and tensorstore use are viewed as torch.bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    bf16 = a.dtype.name == "bfloat16"
    if bf16:
        a = a.view(np.int16)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def _laid_out(t: torch.Tensor, name: str, order, lead: int) -> torch.Tensor:
    t = t.permute(order)
    for _ in range(lead):
        t = t.unsqueeze(0)
    return torch.flip(t, (2, 3)) if _UPSCALING.match(name) else t


def jax_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Every leaf of a JAX GroveModel parameter tree (float, quantized,
    calibrated, fused, with LoRA; or any tree of the same paths, as Adam's
    moments) under its port name, laid out as the port keeps it, on the
    CPU: the float leaves as the copied `to_torch_state_dict` lays them
    out (a fused kernel as its first part), the mask decoder's
    ConvTranspose kernels flipped, quantized leaves as they are, LoRA
    kernels transposed. Raises ValueError for a leaf the port has no
    place for."""
    out = {}
    for path, leaf in _flatten(tree):
        t = _leaf_tensor(leaf)
        name, order, lead = _port_entry(path, t.dim())
        out[name] = _laid_out(t, name, order, lead)
    return out


def _unwritten_act_scale(name: str, cfg) -> bool:
    """A W8A8 tower's activation scale before `calibrate`: the JAX tree
    has no leaf for it until `install_act_scales` (the port's buffer holds
    1.0 then)."""
    if name.rsplit(".", 1)[-1] not in _ACT_SCALES:
        return False
    for prefix, clip in _TOWERS.values():
        if name.startswith(prefix):
            tower = cfg.clip if clip else cfg.sam_enc
            return not tower.quant_static_act
    return False


@torch.no_grad()
def load_jax_tree(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a JAX GroveModel parameter tree into a port model of the same
    config (`jax_state_dict`'s mapping), leaf by leaf: each leaf moves to
    the model's device as it is and is laid out there. Float leaves are
    cast to the tensor's dtype, as the JAX package casts to its template
    (`grove_tpu/api/model.py:63-65`); integer leaves must have the
    buffer's dtype; each tensor keeps its own strides (a W8A8 `kernel_q`
    stays column-major). Strict both ways, as flax's `from_bytes` onto a
    template: a leaf with no place in the model raises ValueError, and so
    does a parameter or buffer that no leaf wrote,
    but for the activation scales of W8A8 towers not yet calibrated, which
    the JAX tree lacks and which are set to 1.0."""
    cfg = model.cfg
    own = model.state_dict()
    written = set()
    for path, leaf in _flatten(tree):
        t = _leaf_tensor(leaf)
        name, order, lead = _port_entry(path, t.dim())
        dst = own.get(name)
        if dst is None:
            raise ValueError(f"load_jax_tree: {path} ({name}) has no "
                             "tensor in the model")
        t = _laid_out(t.to(dst.device), name, order, lead)
        if tuple(t.shape) != tuple(dst.shape) or (
                not (t.is_floating_point() and dst.is_floating_point())
                and t.dtype != dst.dtype):
            raise ValueError(f"load_jax_tree: {path} is {t.dtype}"
                             f"{tuple(t.shape)}, {name} is {dst.dtype}"
                             f"{tuple(dst.shape)}")
        dst.copy_(t)
        written.add(name)
    missing = []
    for name in sorted(set(own) - written):
        if _unwritten_act_scale(name, cfg):
            own[name].fill_(1.0)
        else:
            missing.append(name)
    if missing:
        raise ValueError(f"load_jax_tree: no leaf for {missing[:4]}"
                         f"{' ...' if len(missing) > 4 else ''}")
    return model


def _jax_entry(name: str, t: torch.Tensor, cfg):
    """(JAX path, the tensor in the JAX layout) of a port tensor: the
    inverse of `_port_entry`, the path from the copied `convert_state_dict`
    and the layout from the reader's."""
    m = _FUSED_NAME.match(name)
    part = f"{m[1]}{_FUSED_PARTS[m[2]]}{m[3]}" if m else name
    tree, _ = convert_state_dict({part: _probe(t.dim())}, cfg)
    flat = dict(_flatten(tree))
    if flat:
        (path, probe), = flat.items()
        got, order, lead = _read_layout(path, probe.ndim)
        if got != part:
            raise ValueError(f"{name}: {path} reads back as {got}")
        if m:
            path = path.replace(f"/{_FUSED_PARTS[m[2]]}/", f"/{m[2]}/")
        if _UPSCALING.match(name):
            t = torch.flip(t, (2, 3))
        for _ in range(lead):
            t = t.squeeze(0)
        inverse = tuple(order.index(i) for i in range(len(order)))
        return path, t.permute(inverse)
    m = _QUANT_NAME.match(name)
    if m:
        return f"llama/layers_{m[1]}/{m[2]}/{m[3]}/{m[4]}", t
    m = _LM_HEAD_NAME.match(name)
    if m:
        return f"lm_head/lm_head/{m[1]}", t
    m = _LORA_NAME.match(name)
    if m:
        return (f"llama/layers_{m[1]}/self_attn/{m[2]}/{m[3]}/kernel",
                t.t())
    from ..ops.quant import jax_site_path
    for key, (prefix, clip) in _TOWERS.items():
        mod, _, leaf = name.rpartition(".")
        if name.startswith(prefix) and leaf in _TOWER_LEAVES:
            site = jax_site_path(mod[len(prefix):], clip)
            return f"{key}/{site}/{leaf}", t
    raise ValueError(f"{name}: no leaf of the JAX tree takes this tensor")


def jax_entries(state: Mapping[str, torch.Tensor], cfg
                ) -> Dict[str, Tuple[str, torch.Tensor]]:
    """port name -> (JAX path, the tensor in the JAX layout) for every
    tensor of a port model's `state_dict()` (`_jax_entry`); the activation
    scales of uncalibrated W8A8 towers are left out, as the JAX tree has
    none. Raises ValueError where two tensors take one path."""
    out, seen = {}, set()
    for name, t in state.items():
        if _unwritten_act_scale(name, cfg):
            continue
        path, leaf = _jax_entry(name, t, cfg)
        if path in seen:
            raise ValueError(f"jax_entries: two tensors for {path}")
        seen.add(path)
        out[name] = (path, leaf)
    return out


def jax_tree_from_model(model: nn.Module) -> Dict:
    """The JAX GroveModel parameter tree of a port model: the exact
    inverse of `load_jax_tree` for every model it reads (float, quantized,
    calibrated, fused, LoRA). Each leaf is a view of the model's tensor in
    the JAX layout, on the model's device and in its dtype (a transposed
    Linear weight, the ConvTranspose kernels flipped back are copies);
    `flax_msgpack.dump` copies one leaf at a time to the host. The
    activation scales of uncalibrated W8A8 towers are left out, as the
    JAX tree has none."""
    return _nest(dict(jax_entries(model.state_dict(), model.cfg).values()))
