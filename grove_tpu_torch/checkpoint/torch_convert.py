"""PyTorch GROVE checkpoint <-> the JAX package's parameter tree.

A copy of `grove_tpu/checkpoint/torch_convert.py` without JAX (that module
imports `jax` for two resizes and a tree map): the reference state-dict
namespace (GROVEForCausalLM, `model/GROVE.py:101-125` + submodules) mapped
onto the flax tree of `grove_tpu.models.grove.GroveModel` and back. The
port reads and writes the JAX package's model directories and training
runs through it (`checkpoint.convert.load_jax_tree` /
`jax_tree_from_model`). It works on plain dicts of numpy arrays.

Layout transforms:
  Linear  torch (out, in)            -> flax kernel (in, out)
  Conv2d  torch (out, in, kh, kw)    -> flax kernel (kh, kw, in, out)
  Conv3d  torch (out, in, kd, kh, kw)-> flax kernel (kd, kh, kw, in, out)
  SAM pos_embed (1, g, g, C)         -> (g, g, C) [bicubic-resized if the
                                        checkpoint grid differs, mirroring
                                        train.py:503-577]
  SAM rel_pos_{h,w} (L, hd)          -> linear-resized to 2*grid-1 rows

Every function is the original's text but three: `resize_abs_pos` and
`resize_rel_pos` resize with `checkpoint.convert._resize_axes`
(`jax.image.resize`'s weights in torch) where the original calls
`jax.image.resize`, and `merge_into` copies the nested dicts itself where
the original maps with `jax.tree.map` and unfreezes with flax. The
original's `cast_params` (a `jax.tree.map`) has no copy: nothing of the
port calls it. `tests/test_torch_misc.py` holds the copied text to the
original's.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from ..config import GroveConfig


def _t(x):           # linear weight
    return np.ascontiguousarray(np.asarray(x).T)


def _conv2d(x):
    return np.ascontiguousarray(np.transpose(np.asarray(x), (2, 3, 1, 0)))


def _conv3d(x):
    return np.ascontiguousarray(np.transpose(np.asarray(x), (2, 3, 4, 1, 0)))


def _convT2d(x):
    # torch ConvTranspose2d (in, out, kh, kw) -> flax (kh, kw, in, out)
    return np.ascontiguousarray(np.transpose(np.asarray(x), (2, 3, 0, 1)))


def _ident(x):
    return np.asarray(x)


# sentinel: generic transform (transpose 2-D kernels, pass everything else)
_GENERIC = object()


def resize_abs_pos(pos: np.ndarray, target_grid: int) -> np.ndarray:
    """(1, g0, g0, C) or (g0, g0, C) -> (g, g, C) bicubic."""
    pos = np.asarray(pos)
    if pos.ndim == 4:
        pos = pos[0]
    if pos.shape[0] == target_grid:
        return pos
    from .convert import _resize_axes
    out = _resize_axes(_fp32_tensor(pos), (target_grid, target_grid),
                       "bicubic")
    return out.numpy()


def resize_rel_pos(rel: np.ndarray, target_len: int) -> np.ndarray:
    """(L0, hd) -> (L, hd) linear along the first axis."""
    rel = np.asarray(rel)
    if rel.shape[0] == target_len:
        return rel
    from .convert import _resize_axes
    out = _resize_axes(_fp32_tensor(rel), (target_len,), "bilinear")
    return out.numpy()


def _fp32_tensor(x: np.ndarray):
    """`x` as an fp32 torch tensor (a copy), for `_resize_axes`."""
    import torch
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rules(cfg: GroveConfig) -> List[Tuple[str, str, object]]:
    """(torch-key regex, flax path template with \\1 backrefs, transform)."""
    g = cfg.sam_enc.grid
    return [
        # ---- LLaMA ----
        (r"^model\.embed_tokens\.weight$", "embed_tokens/embedding", _ident),
        (r"^model\.layers\.(\d+)\.self_attn\.(q|k|v|o)_proj\.weight$",
         r"llama/layers_\1/self_attn/\2_proj/kernel", _t),
        (r"^model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight$",
         r"llama/layers_\1/mlp/\2_proj/kernel", _t),
        (r"^model\.layers\.(\d+)\.input_layernorm\.weight$",
         r"llama/layers_\1/input_layernorm/weight", _ident),
        (r"^model\.layers\.(\d+)\.post_attention_layernorm\.weight$",
         r"llama/layers_\1/post_attention_layernorm/weight", _ident),
        (r"^model\.norm\.weight$", "llama/norm/weight", _ident),
        (r"^lm_head\.weight$", "lm_head/lm_head/kernel", _t),
        # ---- projectors ----
        (r"^model\.mm_projector\.0\.weight$", "mm_projector_0/kernel", _t),
        (r"^model\.mm_projector\.0\.bias$", "mm_projector_0/bias", _ident),
        (r"^model\.mm_projector\.2\.weight$", "mm_projector_2/kernel", _t),
        (r"^model\.mm_projector\.2\.bias$", "mm_projector_2/bias", _ident),
        (r"^model\.text_hidden_fcs\.0\.0\.weight$",
         "text_hidden_fcs_0/kernel", _t),
        (r"^model\.text_hidden_fcs\.0\.0\.bias$",
         "text_hidden_fcs_0/bias", _ident),
        (r"^model\.text_hidden_fcs\.0\.2\.weight$",
         "text_hidden_fcs_2/kernel", _t),
        (r"^model\.text_hidden_fcs\.0\.2\.bias$",
         "text_hidden_fcs_2/bias", _ident),
        # ---- CLIP vision tower ----
        (r"^model\.vision_tower\.vision_tower\.vision_model\.embeddings\."
         r"class_embedding$", "vision_tower/class_embedding", _ident),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.embeddings\."
         r"patch_embedding\.weight$", "vision_tower/patch_embedding/kernel",
         _conv2d),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.embeddings\."
         r"position_embedding\.weight$", "vision_tower/position_embedding",
         _ident),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.pre_layrnorm\."
         r"(weight|bias)$",
         lambda m: "vision_tower/pre_layrnorm/"
         + ("scale" if m.group(1) == "weight" else "bias"), _ident),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.encoder\.layers"
         r"\.(\d+)\.self_attn\.(q|k|v|out)_proj\.(weight|bias)$",
         lambda m: (f"vision_tower/layers_{m.group(1)}/self_attn/"
                    f"{m.group(2)}_proj/"
                    + ("kernel" if m.group(3) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.encoder\.layers"
         r"\.(\d+)\.layer_norm([12])\.(weight|bias)$",
         lambda m: (f"vision_tower/layers_{m.group(1)}/layer_norm{m.group(2)}/"
                    + ("scale" if m.group(3) == "weight" else "bias")),
         _ident),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.encoder\.layers"
         r"\.(\d+)\.mlp\.fc([12])\.(weight|bias)$",
         lambda m: (f"vision_tower/layers_{m.group(1)}/fc{m.group(2)}/"
                    + ("kernel" if m.group(3) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.encoder\."
         r"adapters\.(\d+)\.conv3d\.weight$",
         r"vision_tower/adapters_\1/adapter/conv3d/kernel", _conv3d),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.encoder\."
         r"adapters\.(\d+)\.conv3d\.bias$",
         r"vision_tower/adapters_\1/adapter/conv3d/bias", _ident),
        (r"^model\.vision_tower\.vision_tower\.vision_model\.encoder\."
         r"adapters\.(\d+)\.alpha$",
         r"vision_tower/adapters_\1/adapter/alpha", _ident),
        # ---- SAM image encoder ----
        (r"^model\.grounding_encoder\.image_encoder\.patch_embed\.proj\."
         r"weight$", "grounding_encoder/patch_embed/kernel", _conv2d),
        (r"^model\.grounding_encoder\.image_encoder\.patch_embed\.proj\."
         r"bias$", "grounding_encoder/patch_embed/bias", _ident),
        (r"^model\.grounding_encoder\.image_encoder\.pos_embed$",
         "grounding_encoder/pos_embed",
         lambda x: resize_abs_pos(x, g)),
        (r"^model\.grounding_encoder\.image_encoder\.blocks\.(\d+)\."
         r"norm([12])\.(weight|bias)$",
         lambda m: (f"grounding_encoder/blocks_{m.group(1)}/norm{m.group(2)}/"
                    + ("scale" if m.group(3) == "weight" else "bias")),
         _ident),
        (r"^model\.grounding_encoder\.image_encoder\.blocks\.(\d+)\.attn\."
         r"qkv\.(weight|bias)$",
         lambda m: (f"grounding_encoder/blocks_{m.group(1)}/attn/qkv/"
                    + ("kernel" if m.group(2) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.image_encoder\.blocks\.(\d+)\.attn\."
         r"proj\.(weight|bias)$",
         lambda m: (f"grounding_encoder/blocks_{m.group(1)}/attn/proj/"
                    + ("kernel" if m.group(2) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.image_encoder\.blocks\.(\d+)\.attn\."
         r"rel_pos_([hw])$",
         lambda m: (f"grounding_encoder/blocks_{m.group(1)}/attn/"
                    f"rel_pos_{m.group(2)}"), None),  # sized per block below
        (r"^model\.grounding_encoder\.image_encoder\.blocks\.(\d+)\.mlp\."
         r"lin([12])\.(weight|bias)$",
         lambda m: (f"grounding_encoder/blocks_{m.group(1)}/mlp/"
                    f"lin{m.group(2)}/"
                    + ("kernel" if m.group(3) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.image_encoder\.adapters\.(\d+)\."
         r"conv3d\.weight$",
         r"grounding_encoder/adapters_\1/conv3d/kernel", _conv3d),
        (r"^model\.grounding_encoder\.image_encoder\.adapters\.(\d+)\."
         r"conv3d\.bias$",
         r"grounding_encoder/adapters_\1/conv3d/bias", _ident),
        (r"^model\.grounding_encoder\.image_encoder\.adapters\.(\d+)\.alpha$",
         r"grounding_encoder/adapters_\1/alpha", _ident),
        (r"^model\.grounding_encoder\.image_encoder\.neck\.0\.weight$",
         "grounding_encoder/neck_conv1/kernel", _conv2d),
        (r"^model\.grounding_encoder\.image_encoder\.neck\.1\.(weight|bias)$",
         lambda m: "grounding_encoder/neck_ln1/" + m.group(1), _ident),
        (r"^model\.grounding_encoder\.image_encoder\.neck\.2\.weight$",
         "grounding_encoder/neck_conv2/kernel", _conv2d),
        (r"^model\.grounding_encoder\.image_encoder\.neck\.3\.(weight|bias)$",
         lambda m: "grounding_encoder/neck_ln2/" + m.group(1), _ident),
        # ---- region encoder (dormant in video flows, ships in ckpts) ----
        (r"^model\.region_encoder\.mlvl_fuse\.input_conv\.(\d+)\.weight$",
         r"region_encoder/mlvl_fuse/input_conv_\1/kernel", _conv2d),
        (r"^model\.region_encoder\.mlvl_fuse\.input_conv\.(\d+)\.bias$",
         r"region_encoder/mlvl_fuse/input_conv_\1/bias", _ident),
        (r"^model\.region_encoder\.mlvl_fuse\.fuse_convs\.(\d+)\.conv\."
         r"weight$", r"region_encoder/mlvl_fuse/fuse_conv_\1/kernel",
         _conv2d),
        (r"^model\.region_encoder\.mlvl_fuse\.fuse_convs\.(\d+)\.gn\."
         r"(weight|bias)$",
         lambda m: (f"region_encoder/mlvl_fuse/fuse_gn_{m.group(1)}/"
                    + ("scale" if m.group(2) == "weight" else "bias")),
         _ident),
        (r"^model\.region_encoder\.roi_align\.pconvs\.(\d+)\.weight$",
         r"region_encoder/roi_align/pconvs_\1/kernel", _conv2d),
        (r"^model\.region_encoder\.roi_align\.pconvs\.(\d+)\.bias$",
         r"region_encoder/roi_align/pconvs_\1/bias", _ident),
        (r"^model\.region_encoder\.roi_align\.pos_embedd\.([03])\."
         r"(weight|bias)$",
         lambda m: (f"region_encoder/roi_align/pos_embedd_{m.group(1)}/"
                    + ("kernel" if m.group(2) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.region_encoder\.roi_align\.pos_embedd\.([25])\."
         r"(weight|bias)$",
         lambda m: (f"region_encoder/roi_align/pos_embedd_{m.group(1)}/"
                    + ("scale" if m.group(2) == "weight" else "bias")),
         _ident),
        (r"^model\.region_encoder\.roi_align\.flatten_linear\."
         r"(weight|bias)$",
         lambda m: ("region_encoder/roi_align/flatten_linear/"
                    + ("kernel" if m.group(1) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.region_encoder\.roi_align\.updims\.(weight|bias)$",
         lambda m: ("region_encoder/roi_align/updims/"
                    + ("kernel" if m.group(1) == "weight" else "bias")),
         _GENERIC),
        # ---- legacy SAM mask path ----
        (r"^model\.grounding_encoder\.mask_decoder\.output_upscaling\.0\."
         r"(weight|bias)$",
         lambda m: ("mask_decoder/output_upscaling_0/"
                    + ("kernel" if m.group(1) == "weight" else "bias")),
         lambda x: _convT2d(x) if x.ndim == 4 else _ident(x)),
        (r"^model\.grounding_encoder\.mask_decoder\.output_upscaling\.1\."
         r"(weight|bias)$",
         lambda m: "mask_decoder/output_upscaling_1/" + m.group(1), _ident),
        (r"^model\.grounding_encoder\.mask_decoder\.output_upscaling\.3\."
         r"(weight|bias)$",
         lambda m: ("mask_decoder/output_upscaling_3/"
                    + ("kernel" if m.group(1) == "weight" else "bias")),
         lambda x: _convT2d(x) if x.ndim == 4 else _ident(x)),
        (r"^model\.grounding_encoder\.mask_decoder\."
         r"output_hypernetworks_mlps\.(\d+)\.layers\.(\d+)\.(weight|bias)$",
         lambda m: (f"mask_decoder/output_hypernetworks_mlps_{m.group(1)}/"
                    f"layers_{m.group(2)}/"
                    + ("kernel" if m.group(3) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.mask_decoder\.iou_prediction_head\."
         r"layers\.(\d+)\.(weight|bias)$",
         lambda m: (f"mask_decoder/iou_prediction_head/layers_{m.group(1)}/"
                    + ("kernel" if m.group(2) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.prompt_encoder\.mask_downscaling\."
         r"([036])\.(weight|bias)$",
         lambda m: (f"prompt_encoder/mask_down_{m.group(1)}/"
                    + ("kernel" if m.group(2) == "weight" else "bias")),
         lambda x: _conv2d(x) if x.ndim == 4 else _ident(x)),
        (r"^model\.grounding_encoder\.prompt_encoder\.mask_downscaling\."
         r"([14])\.(weight|bias)$",
         lambda m: f"prompt_encoder/mask_down_{m.group(1)}/{m.group(2)}",
         _ident),
        # ---- prompt encoder ----
        (r"^model\.grounding_encoder\.prompt_encoder\.pe_layer\."
         r"positional_encoding_gaussian_matrix$",
         "prompt_encoder/pe_layer/positional_encoding_gaussian_matrix",
         _ident),
        (r"^model\.grounding_encoder\.prompt_encoder\.point_embeddings\."
         r"(\d+)\.weight$", r"prompt_encoder/point_embeddings_\1", _ident),
        (r"^model\.grounding_encoder\.prompt_encoder\.not_a_point_embed\."
         r"weight$", "prompt_encoder/not_a_point_embed", _ident),
        (r"^model\.grounding_encoder\.prompt_encoder\.no_mask_embed\.weight$",
         "prompt_encoder/no_mask_embed", _ident),
        # ---- mask decoder / box head ----
        (r"^model\.grounding_encoder\.mask_decoder\.iou_token\.weight$",
         "mask_decoder/iou_token", _ident),
        (r"^model\.grounding_encoder\.mask_decoder\.mask_tokens\.weight$",
         "mask_decoder/mask_tokens", _ident),
        (r"^model\.grounding_encoder\.mask_decoder\.transformer\.layers\."
         r"(\d+)\.(self_attn|cross_attn_token_to_image|"
         r"cross_attn_image_to_token)\.(q|k|v|out)_proj\.(weight|bias)$",
         lambda m: (f"mask_decoder/transformer/layers_{m.group(1)}/"
                    f"{m.group(2)}/{m.group(3)}_proj/"
                    + ("kernel" if m.group(4) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.mask_decoder\.transformer\.layers\."
         r"(\d+)\.norm([1-4])\.(weight|bias)$",
         lambda m: (f"mask_decoder/transformer/layers_{m.group(1)}/"
                    f"norm{m.group(2)}/"
                    + ("scale" if m.group(3) == "weight" else "bias")),
         _ident),
        (r"^model\.grounding_encoder\.mask_decoder\.transformer\.layers\."
         r"(\d+)\.mlp\.lin([12])\.(weight|bias)$",
         lambda m: (f"mask_decoder/transformer/layers_{m.group(1)}/"
                    f"mlp_lin{m.group(2)}/"
                    + ("kernel" if m.group(3) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.mask_decoder\.transformer\."
         r"final_attn_token_to_image\.(q|k|v|out)_proj\.(weight|bias)$",
         lambda m: (f"mask_decoder/transformer/final_attn_token_to_image/"
                    f"{m.group(1)}_proj/"
                    + ("kernel" if m.group(2) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.mask_decoder\.transformer\."
         r"norm_final_attn\.(weight|bias)$",
         lambda m: ("mask_decoder/transformer/norm_final_attn/"
                    + ("scale" if m.group(1) == "weight" else "bias")),
         _ident),
        (r"^model\.grounding_encoder\.mask_decoder\.bbox_prediction_head\."
         r"0\.(weight|bias)$",
         lambda m: ("mask_decoder/bbox_head_0/"
                    + ("kernel" if m.group(1) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.mask_decoder\.bbox_prediction_head\."
         r"2\.(weight|bias)$",
         lambda m: ("mask_decoder/bbox_head_2/"
                    + ("kernel" if m.group(1) == "weight" else "bias")),
         _GENERIC),
        (r"^model\.grounding_encoder\.mask_decoder\."
         r"temporal_objectness_head\.(weight|bias)$",
         lambda m: ("mask_decoder/temporal_objectness_head/"
                    + ("kernel" if m.group(1) == "weight" else "bias")),
         _GENERIC),
    ]


# keys that exist in the reference checkpoints but have no counterpart in the
# current flax model (legacy SAM mask path, dormant region encoder, SAM
# original-`Sam` extras); they are skipped silently.
SKIP_PATTERNS = (
    r"vision_model\.post_layernorm",
    r"rotary_emb\.inv_freq",
)


def convert_state_dict(sd: Dict[str, np.ndarray], cfg: GroveConfig,
                       strict: bool = False):
    """Convert a torch-namespace state dict (numpy values) to a flax tree.

    Returns (params, report) where report lists unmapped/skipped keys.
    """
    rules = _rules(cfg)
    skip_re = re.compile("|".join(SKIP_PATTERNS))
    flat: Dict[str, np.ndarray] = {}
    unmapped: List[str] = []
    grid = cfg.sam_enc.grid

    for key, val in sd.items():
        val = np.asarray(val)
        if skip_re.search(key):
            continue
        matched = False
        for pat, target, transform in rules:
            m = re.match(pat, key)
            if not m:
                continue
            path = target(m) if callable(target) else m.expand(target)
            if transform is None:
                # rel_pos tables: resize to the window/global span
                bidx = int(m.group(1))
                is_global = bidx in cfg.sam_enc.global_attn_indexes
                span = grid if is_global else cfg.sam_enc.window_size
                out = resize_rel_pos(val, 2 * span - 1)
            elif transform is _GENERIC:
                # generic linear: transpose 2-D weights, keep biases
                out = _t(val) if (val.ndim == 2 and path.endswith("kernel")) \
                    else np.asarray(val)
            else:
                out = transform(val)
            flat[path] = out
            matched = True
            break
        if not matched:
            unmapped.append(key)

    if strict and unmapped:
        raise KeyError(f"unmapped checkpoint keys: {unmapped[:20]}...")

    params: Dict = {}
    for path, val in flat.items():
        node = params
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return params, {"unmapped": unmapped, "converted": len(flat)}


def merge_into(params, converted):
    """Overlay converted weights onto an initialized param tree, checking
    shapes. Returns (new_params, missing, mismatched)."""
    def copy_dicts(tree):
        return ({k: copy_dicts(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree)
    out = copy_dicts(params)
    missing, mismatched = [], []

    def walk(dst, src, prefix=""):
        for k, v in src.items():
            if isinstance(v, dict):
                if k not in dst:
                    missing.append(prefix + k)
                    continue
                walk(dst[k], v, prefix + k + "/")
            else:
                if k not in dst:
                    missing.append(prefix + k)
                    continue
                if tuple(dst[k].shape) != tuple(v.shape):
                    mismatched.append(
                        (prefix + k, tuple(dst[k].shape), tuple(v.shape)))
                    continue
                dst[k] = np.asarray(v).astype(dst[k].dtype)

    walk(out, converted)
    return out, missing, mismatched


# ---------------------------------------------------------------------------
# Export: grove_tpu params -> torch-namespace state dict
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def _inv_linear(x):
    return np.ascontiguousarray(x.T)


def _inv_conv2d(x):
    return np.ascontiguousarray(np.transpose(x, (3, 2, 0, 1)))


def _inv_conv3d(x):
    return np.ascontiguousarray(np.transpose(x, (4, 3, 0, 1, 2)))


def to_torch_state_dict(params, cfg: GroveConfig) -> Dict[str, np.ndarray]:
    """Export a grove_tpu param tree to the reference torch namespace.

    Inverse of `convert_state_dict` for every mapped weight (used for
    round-trip tests and for publishing checkpoints back to the torch
    ecosystem)."""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}

    def put(torch_key, val):
        out[torch_key] = val

    for path, v in flat.items():
        p = path
        m = None
        def ms(pat):
            nonlocal m
            m = re.match(pat, p)
            return m
        if ms(r"^embed_tokens/embedding$"):
            put("model.embed_tokens.weight", v)
        elif ms(r"^llama/layers_(\d+)/self_attn/(q|k|v|o)_proj/kernel$"):
            put(f"model.layers.{m.group(1)}.self_attn.{m.group(2)}_proj."
                f"weight", _inv_linear(v))
        elif ms(r"^llama/layers_(\d+)/mlp/(gate|up|down)_proj/kernel$"):
            put(f"model.layers.{m.group(1)}.mlp.{m.group(2)}_proj.weight",
                _inv_linear(v))
        elif ms(r"^llama/layers_(\d+)/(input_layernorm|"
                r"post_attention_layernorm)/weight$"):
            put(f"model.layers.{m.group(1)}.{m.group(2)}.weight", v)
        elif ms(r"^llama/norm/weight$"):
            put("model.norm.weight", v)
        elif ms(r"^lm_head/lm_head/kernel$"):
            put("lm_head.weight", _inv_linear(v))
        elif ms(r"^mm_projector_([02])/(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.mm_projector.{m.group(1)}.{suffix}", val)
        elif ms(r"^text_hidden_fcs_([02])/(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.text_hidden_fcs.0.{m.group(1)}.{suffix}", val)
        elif ms(r"^vision_tower/class_embedding$"):
            put("model.vision_tower.vision_tower.vision_model.embeddings."
                "class_embedding", v)
        elif ms(r"^vision_tower/patch_embedding/kernel$"):
            put("model.vision_tower.vision_tower.vision_model.embeddings."
                "patch_embedding.weight", _inv_conv2d(v))
        elif ms(r"^vision_tower/position_embedding$"):
            put("model.vision_tower.vision_tower.vision_model.embeddings."
                "position_embedding.weight", v)
        elif ms(r"^vision_tower/pre_layrnorm/(scale|bias)$"):
            suffix = "weight" if m.group(1) == "scale" else "bias"
            put(f"model.vision_tower.vision_tower.vision_model.pre_layrnorm."
                f"{suffix}", v)
        elif ms(r"^vision_tower/layers_(\d+)/self_attn/(q|k|v|out)_proj/"
                r"(kernel|bias)$"):
            suffix = "weight" if m.group(3) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(3) == "kernel" else v
            put(f"model.vision_tower.vision_tower.vision_model.encoder."
                f"layers.{m.group(1)}.self_attn.{m.group(2)}_proj.{suffix}",
                val)
        elif ms(r"^vision_tower/layers_(\d+)/layer_norm([12])/(scale|bias)$"):
            suffix = "weight" if m.group(3) == "scale" else "bias"
            put(f"model.vision_tower.vision_tower.vision_model.encoder."
                f"layers.{m.group(1)}.layer_norm{m.group(2)}.{suffix}", v)
        elif ms(r"^vision_tower/layers_(\d+)/fc([12])/(kernel|bias)$"):
            suffix = "weight" if m.group(3) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(3) == "kernel" else v
            put(f"model.vision_tower.vision_tower.vision_model.encoder."
                f"layers.{m.group(1)}.mlp.fc{m.group(2)}.{suffix}", val)
        elif ms(r"^vision_tower/adapters_(\d+)/adapter/conv3d/kernel$"):
            put(f"model.vision_tower.vision_tower.vision_model.encoder."
                f"adapters.{m.group(1)}.conv3d.weight", _inv_conv3d(v))
        elif ms(r"^vision_tower/adapters_(\d+)/adapter/conv3d/bias$"):
            put(f"model.vision_tower.vision_tower.vision_model.encoder."
                f"adapters.{m.group(1)}.conv3d.bias", v)
        elif ms(r"^vision_tower/adapters_(\d+)/adapter/alpha$"):
            put(f"model.vision_tower.vision_tower.vision_model.encoder."
                f"adapters.{m.group(1)}.alpha", v)
        elif ms(r"^grounding_encoder/patch_embed/kernel$"):
            put("model.grounding_encoder.image_encoder.patch_embed.proj."
                "weight", _inv_conv2d(v))
        elif ms(r"^grounding_encoder/patch_embed/bias$"):
            put("model.grounding_encoder.image_encoder.patch_embed.proj."
                "bias", v)
        elif ms(r"^grounding_encoder/pos_embed$"):
            put("model.grounding_encoder.image_encoder.pos_embed", v[None])
        elif ms(r"^grounding_encoder/blocks_(\d+)/norm([12])/(scale|bias)$"):
            suffix = "weight" if m.group(3) == "scale" else "bias"
            put(f"model.grounding_encoder.image_encoder.blocks.{m.group(1)}."
                f"norm{m.group(2)}.{suffix}", v)
        elif ms(r"^grounding_encoder/blocks_(\d+)/attn/qkv/(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.grounding_encoder.image_encoder.blocks.{m.group(1)}."
                f"attn.qkv.{suffix}", val)
        elif ms(r"^grounding_encoder/blocks_(\d+)/attn/proj/(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.grounding_encoder.image_encoder.blocks.{m.group(1)}."
                f"attn.proj.{suffix}", val)
        elif ms(r"^grounding_encoder/blocks_(\d+)/attn/rel_pos_([hw])$"):
            put(f"model.grounding_encoder.image_encoder.blocks.{m.group(1)}."
                f"attn.rel_pos_{m.group(2)}", v)
        elif ms(r"^grounding_encoder/blocks_(\d+)/mlp/lin([12])/"
                r"(kernel|bias)$"):
            suffix = "weight" if m.group(3) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(3) == "kernel" else v
            put(f"model.grounding_encoder.image_encoder.blocks.{m.group(1)}."
                f"mlp.lin{m.group(2)}.{suffix}", val)
        elif ms(r"^grounding_encoder/adapters_(\d+)/conv3d/kernel$"):
            put(f"model.grounding_encoder.image_encoder.adapters."
                f"{m.group(1)}.conv3d.weight", _inv_conv3d(v))
        elif ms(r"^grounding_encoder/adapters_(\d+)/conv3d/bias$"):
            put(f"model.grounding_encoder.image_encoder.adapters."
                f"{m.group(1)}.conv3d.bias", v)
        elif ms(r"^grounding_encoder/adapters_(\d+)/alpha$"):
            put(f"model.grounding_encoder.image_encoder.adapters."
                f"{m.group(1)}.alpha", v)
        elif ms(r"^grounding_encoder/neck_conv([12])/kernel$"):
            idx = "0" if m.group(1) == "1" else "2"
            put(f"model.grounding_encoder.image_encoder.neck.{idx}.weight",
                _inv_conv2d(v))
        elif ms(r"^grounding_encoder/neck_ln([12])/(weight|bias)$"):
            idx = "1" if m.group(1) == "1" else "3"
            put(f"model.grounding_encoder.image_encoder.neck.{idx}."
                f"{m.group(2)}", v)
        elif ms(r"^region_encoder/mlvl_fuse/input_conv_(\d+)/kernel$"):
            put(f"model.region_encoder.mlvl_fuse.input_conv.{m.group(1)}."
                f"weight", _inv_conv2d(v))
        elif ms(r"^region_encoder/mlvl_fuse/input_conv_(\d+)/bias$"):
            put(f"model.region_encoder.mlvl_fuse.input_conv.{m.group(1)}."
                f"bias", v)
        elif ms(r"^region_encoder/mlvl_fuse/fuse_conv_(\d+)/kernel$"):
            put(f"model.region_encoder.mlvl_fuse.fuse_convs.{m.group(1)}."
                f"conv.weight", _inv_conv2d(v))
        elif ms(r"^region_encoder/mlvl_fuse/fuse_gn_(\d+)/(scale|bias)$"):
            suffix = "weight" if m.group(2) == "scale" else "bias"
            put(f"model.region_encoder.mlvl_fuse.fuse_convs.{m.group(1)}."
                f"gn.{suffix}", v)
        elif ms(r"^region_encoder/roi_align/pconvs_(\d+)/kernel$"):
            put(f"model.region_encoder.roi_align.pconvs.{m.group(1)}.weight",
                _inv_conv2d(v))
        elif ms(r"^region_encoder/roi_align/pconvs_(\d+)/bias$"):
            put(f"model.region_encoder.roi_align.pconvs.{m.group(1)}.bias", v)
        elif ms(r"^region_encoder/roi_align/pos_embedd_([03])/"
                r"(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.region_encoder.roi_align.pos_embedd.{m.group(1)}."
                f"{suffix}", val)
        elif ms(r"^region_encoder/roi_align/pos_embedd_([25])/"
                r"(scale|bias)$"):
            suffix = "weight" if m.group(2) == "scale" else "bias"
            put(f"model.region_encoder.roi_align.pos_embedd.{m.group(1)}."
                f"{suffix}", v)
        elif ms(r"^region_encoder/roi_align/(flatten_linear|updims)/"
                r"(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.region_encoder.roi_align.{m.group(1)}.{suffix}", val)
        elif ms(r"^mask_decoder/output_upscaling_([03])/(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = (np.ascontiguousarray(np.transpose(v, (2, 3, 0, 1)))
                   if v.ndim == 4 else v)
            put(f"model.grounding_encoder.mask_decoder.output_upscaling."
                f"{m.group(1)}.{suffix}", val)
        elif ms(r"^mask_decoder/output_upscaling_1/(weight|bias)$"):
            put(f"model.grounding_encoder.mask_decoder.output_upscaling.1."
                f"{m.group(1)}", v)
        elif ms(r"^mask_decoder/output_hypernetworks_mlps_(\d+)/"
                r"layers_(\d+)/(kernel|bias)$"):
            suffix = "weight" if m.group(3) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(3) == "kernel" else v
            put(f"model.grounding_encoder.mask_decoder."
                f"output_hypernetworks_mlps.{m.group(1)}.layers."
                f"{m.group(2)}.{suffix}", val)
        elif ms(r"^mask_decoder/iou_prediction_head/layers_(\d+)/"
                r"(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.grounding_encoder.mask_decoder.iou_prediction_head."
                f"layers.{m.group(1)}.{suffix}", val)
        elif ms(r"^prompt_encoder/mask_down_([036])/(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_conv2d(v) if v.ndim == 4 else v
            put(f"model.grounding_encoder.prompt_encoder.mask_downscaling."
                f"{m.group(1)}.{suffix}", val)
        elif ms(r"^prompt_encoder/mask_down_([14])/(weight|bias)$"):
            put(f"model.grounding_encoder.prompt_encoder.mask_downscaling."
                f"{m.group(1)}.{m.group(2)}", v)
        elif ms(r"^prompt_encoder/pe_layer/"
                r"positional_encoding_gaussian_matrix$"):
            put("model.grounding_encoder.prompt_encoder.pe_layer."
                "positional_encoding_gaussian_matrix", v)
        elif ms(r"^prompt_encoder/point_embeddings_(\d+)$"):
            put(f"model.grounding_encoder.prompt_encoder.point_embeddings."
                f"{m.group(1)}.weight", v)
        elif ms(r"^prompt_encoder/not_a_point_embed$"):
            put("model.grounding_encoder.prompt_encoder.not_a_point_embed."
                "weight", v)
        elif ms(r"^prompt_encoder/no_mask_embed$"):
            put("model.grounding_encoder.prompt_encoder.no_mask_embed."
                "weight", v)
        elif ms(r"^mask_decoder/iou_token$"):
            put("model.grounding_encoder.mask_decoder.iou_token.weight", v)
        elif ms(r"^mask_decoder/mask_tokens$"):
            put("model.grounding_encoder.mask_decoder.mask_tokens.weight", v)
        elif ms(r"^mask_decoder/transformer/layers_(\d+)/(self_attn|"
                r"cross_attn_token_to_image|cross_attn_image_to_token)/"
                r"(q|k|v|out)_proj/(kernel|bias)$"):
            suffix = "weight" if m.group(4) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(4) == "kernel" else v
            put(f"model.grounding_encoder.mask_decoder.transformer.layers."
                f"{m.group(1)}.{m.group(2)}.{m.group(3)}_proj.{suffix}", val)
        elif ms(r"^mask_decoder/transformer/layers_(\d+)/norm([1-4])/"
                r"(scale|bias)$"):
            suffix = "weight" if m.group(3) == "scale" else "bias"
            put(f"model.grounding_encoder.mask_decoder.transformer.layers."
                f"{m.group(1)}.norm{m.group(2)}.{suffix}", v)
        elif ms(r"^mask_decoder/transformer/layers_(\d+)/mlp_lin([12])/"
                r"(kernel|bias)$"):
            suffix = "weight" if m.group(3) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(3) == "kernel" else v
            put(f"model.grounding_encoder.mask_decoder.transformer.layers."
                f"{m.group(1)}.mlp.lin{m.group(2)}.{suffix}", val)
        elif ms(r"^mask_decoder/transformer/final_attn_token_to_image/"
                r"(q|k|v|out)_proj/(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.grounding_encoder.mask_decoder.transformer."
                f"final_attn_token_to_image.{m.group(1)}_proj.{suffix}", val)
        elif ms(r"^mask_decoder/transformer/norm_final_attn/(scale|bias)$"):
            suffix = "weight" if m.group(1) == "scale" else "bias"
            put(f"model.grounding_encoder.mask_decoder.transformer."
                f"norm_final_attn.{suffix}", v)
        elif ms(r"^mask_decoder/bbox_head_([02])/(kernel|bias)$"):
            suffix = "weight" if m.group(2) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(2) == "kernel" else v
            put(f"model.grounding_encoder.mask_decoder.bbox_prediction_head."
                f"{m.group(1)}.{suffix}", val)
        elif ms(r"^mask_decoder/temporal_objectness_head/(kernel|bias)$"):
            suffix = "weight" if m.group(1) == "kernel" else "bias"
            val = _inv_linear(v) if m.group(1) == "kernel" else v
            put(f"model.grounding_encoder.mask_decoder."
                f"temporal_objectness_head.{suffix}", val)
        # unmatched paths are silently left out (they have no torch analogue)
    return out
