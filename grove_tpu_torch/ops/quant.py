"""Serving quantization in torch (any device): weight quantisers, module
transforms and the static activation-scale calibration.

Counterpart of `grove_tpu/ops/quant.py`, with the same layouts and names,
so the port's buffers hold the same bytes as the JAX package's parameter
tree and carry over without a converter:

* int8 per output channel (`quantize_kernel`): kernel_q (..., K, N) int8
  and scale (N,) fp32, absmax / 127 over every non-output axis (the
  adapters' 5-D conv kernels share one scale per output channel);
* int4 per (group, output) (`quantize_kernel_int4`): kernel_q4p (K/2, N)
  int8, group-pair packed (`pack_int4`), and scale (K/G, N) fp32,
  absmax / 7.

Kernels are (in, out) = (K, N), the JAX layout: the transpose of an
`nn.Linear` weight. Both libraries round half to even and divide in fp32,
so the results are byte-identical to the numpy originals.

Module transforms, all IN PLACE, layer by layer on the model's device,
each float weight dropped once its int8 copy exists: `quantize_llama_`
(`quantize_llama_tree` / `quantize_llama_tree_int4`), and for the W8A8
towers `quantize_sam_` / `quantize_clip_` (`quantize_sam_tree` /
`quantize_clip_tree`, the sites of SAM_QUANT_PATTERNS / CLIP_QUANT_PATTERNS,
`quant.py:43-61`), joined by `quantize_vision_`.

Calibration (`quant.py:225-284`): `recording_act_stats` turns on the
absmax recording of a tower's quant sites (torch has no flax `sow`), and
`collect_act_stats` returns the per-site maxima of one dynamic-mode pass
under the JAX path names (`blocks_0/norm1/absmax`,
`layers_0/self_attn/out_proj/absmax`, ...); `merge_act_stats` takes the
max of two passes and `install_act_scales` writes absmax / 127 * margin,
floored at 1e-12, into the sites' `act_scale` / `proj_act_scale`
buffers. `calibrate_vision_` runs the whole flow on a GroveModel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Callable, Dict, Iterator, Tuple

import torch
from torch import nn

LLAMA_PROJECTIONS = (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                     ("mlp", ("gate_proj", "up_proj", "down_proj")))


def quantize_kernel(kernel: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(..., in, out) -> int8 kernel + per-output-channel fp32 scale (max
    over every non-output axis), `quant.py:64-73`. The results are
    contiguous whatever the layout of `kernel` (e.g. a transposed
    `nn.Linear` weight)."""
    k = kernel.float().contiguous()
    scale = k.reshape(-1, k.shape[-1]).abs().amax(0) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale


def int4_group(k_in: int, group: int) -> int:
    """The group size `quantize_kernel_int4` and `Int4Dense` use for an input
    width: `group`, halved until 2 * group divides it (`quant.py:157-158`,
    for narrow test configs)."""
    while group > 1 and k_in % (2 * group):
        group //= 2
    if k_in % (2 * group):
        raise ValueError(f"int4: input width {k_in} has no even group count")
    return group


def pack_int4(q: torch.Tensor, group: int) -> torch.Tensor:
    """int4 values (K, N) int8 in [-8, 7] -> PACKED (K/2, N) int8: packed
    row p*G + i holds logical row 2p*G + i in its low nibble and
    (2p+1)*G + i in its high nibble (`quant.py:109-129`)."""
    kin, out = q.shape
    if kin % (2 * group):
        raise ValueError(f"pack_int4: {kin} rows, group {group}")
    v = q.reshape(kin // (2 * group), 2, group, out).to(torch.int32)
    packed = (v[:, 0] & 0x0F) | ((v[:, 1] & 0x0F) << 4)
    # the byte 0..255 as a signed int8, as numpy's astype(np.int8) wraps it
    packed = torch.where(packed > 127, packed - 256, packed)
    return packed.to(torch.int8).reshape(kin // 2, out)


def unpack_int4(packed: torch.Tensor, group: int) -> torch.Tensor:
    """PACKED (K/2, N) int8 -> (K/G groups, G, N) int8 values; the inverse
    of `pack_int4` (`quant.py:132-142`)."""
    half, out = packed.shape
    s = half // group
    p32 = packed.reshape(s, group, out).to(torch.int32)
    lo = (p32 << 28) >> 28                 # sign-extended low nibble
    hi = p32 >> 4                          # arithmetic: high nibble
    return torch.stack([lo, hi], dim=1).reshape(2 * s, group, out).to(
        torch.int8)


def quantize_kernel_int4(kernel: torch.Tensor, group: int = 128
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) -> (packed (K/2, N) int8, scale (K/G, N) fp32): group-wise
    round-to-nearest absmax over `group`-row slices of the input dim,
    q = round(k / s) in [-7, 7], s = absmax / 7 (`quant.py:145-165`).
    The results are contiguous whatever the layout of `kernel`."""
    k = kernel.float().contiguous()
    kin, out = k.shape
    group = int4_group(kin, group)
    g = k.reshape(kin // group, group, out)
    scale = (g.abs().amax(1) / 7.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(g / scale[:, None, :]), -7, 7)
    return pack_int4(q.reshape(kin, out).to(torch.int8), group), scale


@torch.no_grad()
def quantize_llama_(model: nn.Module, bits: int, group: int = 128):
    """Quantise a `models.grove.GroveModel`'s LLM IN PLACE: the seven
    projections of every layer become `Int4Linear` (bits=4, group-wise) or
    `Int8Linear` (bits=8), and `lm_head` becomes `Int8Linear` either way
    (`quant.py:103-106`, `:179-204`). It works layer by layer on the
    model's device and drops each float weight once its quantised buffers
    exist, so a full-width model quantises on the card without two copies.
    `model.cfg` is updated to `weight_quant=True, weight_quant_bits=bits`.
    Returns the model."""
    from ..models.layers import Int4Linear, Int8Linear
    if bits not in (4, 8):
        raise ValueError(f"quantize_llama_: bits must be 4 or 8, got {bits}")
    llama = dataclasses.replace(model.cfg.llama, weight_quant=True,
                                weight_quant_bits=bits, quant_group=group)

    def swap(parent: nn.Module, name: str, int4: bool):
        lin = getattr(parent, name)
        if not isinstance(lin, nn.Linear):
            raise TypeError(f"quantize_llama_: {name} is "
                            f"{type(lin).__name__}, not nn.Linear (already "
                            "quantized?)")
        kernel = lin.weight.t()            # (in, out), the JAX layout
        new = (Int4Linear.from_kernel(kernel, group) if int4
               else Int8Linear.from_kernel(kernel))
        setattr(parent, name, new)

    for layer in model.model.layers:
        for sub, names in LLAMA_PROJECTIONS:
            for name in names:
                swap(getattr(layer, sub), name, bits == 4)
        layer.self_attn.cfg = llama
    swap(model, "lm_head", False)
    model.cfg = dataclasses.replace(model.cfg, llama=llama)
    return model


# ---------------------------------------------------------------------------
# W8A8 vision towers
# ---------------------------------------------------------------------------

def _float(mod: nn.Module, kind, what: str) -> nn.Module:
    if type(mod) is not kind:
        raise TypeError(f"{what} is {type(mod).__name__}, not "
                        f"{kind.__name__} (already quantized?)")
    return mod


@torch.no_grad()
def quantize_sam_(encoder: nn.Module) -> nn.Module:
    """W8A8-quantize a `models.sam_encoder.SamImageEncoder` IN PLACE: the
    qkv / proj / lin1 / lin2 linears of every block become `Int8Linear`,
    the norms `LayerNormQuant`, the adapters' Conv3d `Int8Conv3d`
    (`quantize_sam_tree`). Activation scales are dynamic until
    `install_act_scales`; `encoder.cfg` gets `quant_w8a8=True,
    quant_static_act=False`."""
    from ..models.layers import Int8Conv3d, Int8Linear, LayerNormQuant
    cfg = dataclasses.replace(encoder.cfg, quant_w8a8=True,
                              quant_static_act=False)
    lin = dict(act_quant=True)
    for i, blk in enumerate(encoder.blocks):
        for name in ("norm1", "norm2"):
            setattr(blk, name, LayerNormQuant.from_layernorm(
                _float(getattr(blk, name), nn.LayerNorm, f"blocks.{i}.{name}"),
                use_kernel=cfg.quant_ln_kernel))
        attn, mlp = blk.attn, blk.mlp
        for name in ("qkv", "proj"):
            setattr(attn, name, Int8Linear.from_linear(
                _float(getattr(attn, name), nn.Linear, f"blocks.{i}.{name}"),
                **lin))
        attn.register_buffer("proj_act_scale", torch.ones(
            (), dtype=torch.float32, device=attn.qkv.kernel_q.device))
        attn.static_act = False
        mlp.lin1 = Int8Linear.from_linear(
            _float(mlp.lin1, nn.Linear, f"blocks.{i}.mlp.lin1"), **lin)
        mlp.lin2 = Int8Linear.from_linear(
            _float(mlp.lin2, nn.Linear, f"blocks.{i}.mlp.lin2"),
            act_site=True, **lin)
    for i, ad in enumerate(encoder.adapters):
        ad.conv3d = Int8Conv3d.from_conv(
            _float(ad.conv3d, nn.Conv3d, f"adapters.{i}.conv3d"))
    encoder.cfg = cfg
    return encoder


@torch.no_grad()
def quantize_clip_(tower: nn.Module) -> nn.Module:
    """W8A8-quantize a `models.clip.ClipVisionTransformer` IN PLACE: q/k/v/
    out_proj and fc1/fc2 of every layer become `Int8Linear`, layer_norm1/2
    `LayerNormQuant`, the adapters' Conv3d `Int8Conv3d`
    (`quantize_clip_tree`); `pre_layrnorm`, the embeddings and the pooling
    stay float. `tower.cfg` gets `quant_w8a8=True, quant_static_act=False`."""
    from ..models.layers import Int8Conv3d, Int8Linear, LayerNormQuant
    cfg = dataclasses.replace(tower.cfg, quant_w8a8=True,
                              quant_static_act=False)
    for i, layer in enumerate(tower.encoder.layers):
        for name in ("layer_norm1", "layer_norm2"):
            setattr(layer, name, LayerNormQuant.from_layernorm(
                _float(getattr(layer, name), nn.LayerNorm,
                       f"layers.{i}.{name}"),
                use_kernel=cfg.quant_ln_kernel))
        for parent, name in ((layer.self_attn, "q_proj"),
                             (layer.self_attn, "k_proj"),
                             (layer.self_attn, "v_proj"),
                             (layer.self_attn, "out_proj"),
                             (layer.mlp, "fc1"), (layer.mlp, "fc2")):
            setattr(parent, name, Int8Linear.from_linear(
                _float(getattr(parent, name), nn.Linear,
                       f"layers.{i}.{name}"),
                act_quant=True, act_site=name in ("out_proj", "fc2")))
    for i, ad in enumerate(tower.encoder.adapters):
        ad.conv3d = Int8Conv3d.from_conv(
            _float(ad.conv3d, nn.Conv3d, f"adapters.{i}.conv3d"))
    tower.cfg = cfg
    return tower


def vision_towers(model: nn.Module) -> Dict[str, nn.Module]:
    """A GroveModel's two towers under their JAX parameter-tree names."""
    return {"vision_tower": model.model.vision_tower.vision_tower.vision_model,
            "grounding_encoder": model.model.grounding_encoder.image_encoder}


@torch.no_grad()
def quantize_vision_(model: nn.Module) -> nn.Module:
    """`quantize_clip_` + `quantize_sam_` on a GroveModel, and `model.cfg`
    with both towers' `quant_w8a8=True` (`api/model.py:123-131`)."""
    towers = vision_towers(model)
    quantize_clip_(towers["vision_tower"])
    quantize_sam_(towers["grounding_encoder"])
    model.cfg = dataclasses.replace(
        model.cfg, clip=towers["vision_tower"].cfg,
        sam_enc=towers["grounding_encoder"].cfg)
    return model


def jax_site_path(name: str, clip: bool) -> str:
    """A module's path inside a port tower -> its JAX module path:
    `blocks.3.mlp.lin2` -> `blocks_3/mlp/lin2`; for CLIP
    `encoder.layers.3.mlp.fc2` -> `layers_3/fc2` and
    `encoder.adapters.1.conv3d` -> `adapters_1/adapter/conv3d`."""
    p = re.sub(r"^encoder\.", "", name)
    p = re.sub(r"\b(layers|blocks|adapters)\.(\d+)", r"\1_\2", p)
    if clip:
        p = re.sub(r"^(layers_\d+)\.mlp\.", r"\1.", p)
        p = re.sub(r"^(adapters_\d+)\.", r"\1.adapter.", p)
    return p.replace(".", "/")


# stat a site records -> the buffer its calibrated scale goes to
_SCALE_OF = {"absmax": "act_scale", "proj_absmax": "proj_act_scale"}


def act_sites(tower: nn.Module, clip: bool) -> Iterator[Tuple[str, nn.Module,
                                                              str]]:
    """(JAX path, module, stat name) of every W8A8 site of a tower that
    quantizes its own input."""
    for name, mod in tower.named_modules():
        for stat, buf in _SCALE_OF.items():
            if buf in mod._buffers:
                yield jax_site_path(name, clip), mod, stat


@contextlib.contextmanager
def recording_act_stats(tower: nn.Module, clip: bool):
    """Record, while the block runs, the running absmax at every quant site
    of `tower`; the yielded dict is filled on exit with
    `{"<JAX path>/<stat>": absmax}` (python floats)."""
    sites = list(act_sites(tower, clip))
    for _, mod, _ in sites:
        mod.act_stats = {}
    out: Dict[str, float] = {}
    try:
        yield out
    finally:
        for path, mod, stat in sites:
            if stat in mod.act_stats:
                out[f"{path}/{stat}"] = float(mod.act_stats[stat])
        for _, mod, _ in sites:
            mod.act_stats = None


def set_static_act_(tower: nn.Module, static: bool) -> None:
    """Switch every quant site of a tower between dynamic and static
    activation scales."""
    for mod in tower.modules():
        if hasattr(mod, "static_act"):
            mod.static_act = static


def collect_act_stats(tower: nn.Module, run: Callable[[], object],
                      clip: bool) -> Dict[str, float]:
    """Call `run()` (a forward that goes through `tower`) once in dynamic
    mode with recording on, and return the per-site absmax
    (`quant.py:244-253`). The tower is left in dynamic mode."""
    set_static_act_(tower, False)
    with torch.inference_mode(), recording_act_stats(tower, clip) as stats:
        run()
    return stats


def merge_act_stats(a: Dict[str, float], b: Dict[str, float]
                    ) -> Dict[str, float]:
    """Key-wise max of two stats dicts (multi-batch calibration)."""
    if set(a) != set(b):
        raise KeyError(f"merge_act_stats: keys differ: "
                       f"{sorted(set(a) ^ set(b))[:4]}")
    return {k: max(a[k], b[k]) for k in a}


@torch.no_grad()
def install_act_scales(tower: nn.Module, stats: Dict[str, float], clip: bool,
                       margin: float = 1.0) -> None:
    """Write max(absmax / 127 * margin, 1e-12) into each site's `act_scale`
    / `proj_act_scale` buffer (`quant.py:261-284`), strictly: every site
    has a stat and every stat a site. Does not switch modes."""
    seen = set()
    for path, mod, stat in act_sites(tower, clip):
        key = f"{path}/{stat}"
        if key not in stats:
            raise KeyError(f"install_act_scales: no stat {key}")
        scale = max(stats[key] / 127.0 * margin, 1e-12)
        getattr(mod, _SCALE_OF[stat]).fill_(scale)
        seen.add(key)
    extra = sorted(set(stats) - seen)
    if extra:
        raise KeyError(f"install_act_scales: stats with no site {extra[:4]}")


def calibrate_vision_(model: nn.Module, clip_frames, sam_frames,
                      margin: float = 1.0) -> Dict[str, Dict[str, float]]:
    """The JAX `GroveForCausalLM.calibrate` flow on a GroveModel whose towers
    are W8A8 (`quantize_vision_`), IN PLACE: one dynamic-mode
    `encode_video(clip_frames)` and `encode_grounding(sam_frames)` with
    recording on, the scales installed, both towers and `model.cfg`
    switched to `quant_static_act=True`. Returns the stats by tower."""
    towers = vision_towers(model)
    if not all(t.cfg.quant_w8a8 for t in towers.values()):
        raise ValueError("calibrate() requires a quantize(vision=True) "
                         "instance")
    dev = model.device
    runs = {"vision_tower": lambda: model.encode_video(
                torch.as_tensor(clip_frames, device=dev)),
            "grounding_encoder": lambda: model.encode_grounding(
                torch.as_tensor(sam_frames, device=dev))}
    stats = {}
    for key, tower in towers.items():
        clip = key == "vision_tower"
        stats[key] = collect_act_stats(tower, runs[key], clip)
        install_act_scales(tower, stats[key], clip, margin)
        set_static_act_(tower, True)
        tower.cfg = dataclasses.replace(tower.cfg, quant_static_act=True)
    model.cfg = dataclasses.replace(
        model.cfg, clip=towers["vision_tower"].cfg,
        sam_enc=towers["grounding_encoder"].cfg)
    return stats
