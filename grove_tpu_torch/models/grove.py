"""GROVE top-level model: grounded video caption generation, inference in
bf16 or with the quantized serving modules (`ops.quant`), and the training
forward (`forward_train`, driven by `train.step`).

Counterpart of `grove_tpu/models/grove.py` (`GroveModel`), with the module
tree of the reference `GROVEForCausalLM` so its state dict carries the
reference torch names (`model.*`, `lm_head.*`):

  encode_video        CLIP tower + mm_projector (exact-erf GELU)
  encode_grounding    SAM encoder -> (B*T, HW, C)
  prefill/decode_step the generation loop innards over the KV cache (bf16
                      or int8)
  ground              [DET] gather -> text projection -> prompt encoder ->
                      two-way transformer -> box/objectness heads
  forward_boxes       teacher-forced boxes for the sliding windows
  forward_train       the loss dict of one batch (`ops.losses`)
  encode_regions      `<bbox>` region queries from the CLIP levels
                      (`models.region`); `splice_regions` writes them at
                      the `<bbox>` tokens
  segment             SAM-style promptable masks: points, boxes and a mask
                      input through the prompt encoder, then the legacy
                      mask path (`GroveBoxDecoder.predict_masks`)

Static-shape contract as in the JAX package:
  frames_clip  (B, T, Hc, Wc, 3) uint8 at the CLIP size, or normalized
  frames_sam   (B, T, Hs, Ws, 3) uint8 at the SAM size, or normalized
  input_ids    (B, Ls) spliced ids; video_start (B,); det_positions (B, P)
  boxes out    (B, T, P, 4) cxcywh in [0, 1]; objectness logits (B, T, P)

Frames may also arrive raw (uint8 at the source size) or as packed YUV420P
(B, T, 3H/2, W): `_norm_clip` / `_norm_sam` then convert and resize on the
device as the JAX package does with `jax.image.resize` (`_resize_weights`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..config import GroveConfig
from ..data.preprocess import (CLIP_MEAN, CLIP_STD, SAM_MEAN, SAM_STD,
                               YUV_OFFSET, YUV_TO_RGB)
from ..ops.losses import grove_total_loss
from .clip import ClipVisionTower
from .llama import LlamaModel, _dense
from .region import MLVLROIQueryModule
from .sam_decoder import GroveBoxDecoder, PromptEncoder
from .sam_encoder import SamImageEncoder, encode_frames_chunked


def _keys_cubic(x):
    """`jax.image.resize`'s cubic (Keys, a = -0.5) at |offsets| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _resize_weights(in_size: int, out_size: int, method: str, device):
    """(in_size, out_size) fp32 weights of `jax.image.resize` along one
    axis (`scale_and_translate`, `jax/_src/image/scale.py:
    compute_weight_mat`): the kernel stretched by max(in/out, 1) (the
    antialias of a downscale), each output column normalized by its sum,
    and zero where the sample falls outside [-0.5, in - 0.5]. A dense
    product, as XLA computes it (`F.interpolate` has neither the antialias
    nor a = -0.5)."""
    kernel = {"bicubic": _keys_cubic, "bilinear": _triangle}[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    f = dict(device=device, dtype=torch.float32)
    sample = (torch.arange(out_size, **f) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, **f)[:, None]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_frames(frames, out_hw, method: str, crop=None):
    """(B, T, H, W, 3) -> (B, T, h, w, 3) fp32, `jax.image.resize` to
    `out_hw` by `method`; `crop` = (top, left, size) keeps only that square
    of the resized frame (the output columns of the weights outside it are
    dropped, which changes no kept value)."""
    h, w = frames.shape[2:4]
    wh = _resize_weights(h, out_hw[0], method, frames.device)
    ww = _resize_weights(w, out_hw[1], method, frames.device)
    if crop is not None:
        top, left, size = crop
        wh, ww = wh[:, top:top + size], ww[:, left:left + size]
    return torch.einsum("bthwc,hy,wx->btyxc", frames.float(), wh, ww)


class SamGrounding(nn.Module):
    """The reference's `Sam` container (`grounding_encoder`)."""

    def __init__(self, cfg: GroveConfig, *, remat: bool = False, device=None,
                 dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.image_encoder = SamImageEncoder(cfg.sam_enc, remat=remat, **f)
        self.prompt_encoder = PromptEncoder(cfg.sam_dec, **f)
        self.mask_decoder = GroveBoxDecoder(cfg.sam_dec, **f)


class GroveBackbone(LlamaModel):
    """`model.*`: the LLaMA model plus the multimodal modules, as in the
    reference's LlavaLlamaModel subclass."""

    def __init__(self, cfg: GroveConfig, *, remat: bool = False, device=None,
                 dtype=None):
        f = dict(device=device, dtype=dtype)
        super().__init__(cfg.llama, remat=remat, **f)
        d = cfg.llama.hidden_size
        self.vision_tower = ClipVisionTower(
            cfg.clip, (cfg.pool_t, cfg.pool_h, cfg.pool_w), remat=remat, **f)
        self.mm_projector = nn.Sequential(
            nn.Linear(cfg.clip.hidden_size, d, **f), nn.GELU(),
            nn.Linear(d, d, **f))
        self.grounding_encoder = SamGrounding(cfg, remat=remat, **f)
        self.text_hidden_fcs = nn.ModuleList([nn.Sequential(
            nn.Linear(d, d, **f), nn.ReLU(), nn.Linear(d, cfg.out_dim, **f))])
        if cfg.with_region:
            # one level per CLIP feature tap: layers select_layer,
            # select_layer - 3, ... (at most 4), as the JAX tower returns
            taps = range(cfg.clip.num_layers + 1)[
                cfg.clip.select_layer::-cfg.clip.adapter_every]
            self.region_encoder = MLVLROIQueryModule(
                cfg.clip.hidden_size, d, min(4, len(taps)), **f)


class GroveModel(nn.Module):
    """`remat` (`grove.py:46`): the CLIP layers, the SAM blocks and, on the
    cache-free pass, the LLaMA layers run under `torch.utils.checkpoint`
    when gradients are on, recomputed in the backward instead of kept.

    `llm_act_sharding` (`grove.py:48-56`) takes a ("data", "model")
    `DeviceMesh` (`parallel.mesh.make_mesh`) and adds no parameter: with
    it, `parallel.sharding.shard_pytree` makes the LLaMA's cache-free
    residual stream sequence-parallel over "model"
    (`LlamaModel.act_sharding`). JAX's `ground_act_sharding`, which pins
    the ground path's rows to "data", has no counterpart: every data rank
    holds only its own rows, so the ground path already runs per data
    rank."""

    def __init__(self, cfg: GroveConfig, *, remat: bool = False, device=None,
                 dtype: torch.dtype = torch.bfloat16, llm_act_sharding=None):
        super().__init__()
        self.cfg = cfg
        self.llm_act_sharding = llm_act_sharding
        self.model = GroveBackbone(cfg, remat=remat, device=device,
                                   dtype=dtype)
        # int8 even in the int4 config, as `llama.py:459-466` pins it
        self.lm_head = _dense(cfg.llama, cfg.llama.hidden_size,
                              cfg.llama.padded_vocab_size, bits=8,
                              device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    # ------------------------------------------------------------------
    # encoders
    # ------------------------------------------------------------------

    def _yuv420_to_rgb(self, packed):
        """Packed (B, T, 3H/2, W) uint8 YUV420P -> (B, T, H, W, 3) fp32 RGB
        in [0, 255] (`grove.py:96-113`): BT.601 limited range,
        nearest-neighbour chroma, the 3 x 3 product written out so that no
        TF32 matmul rounds it."""
        b, t, h32, w = packed.shape
        h = h32 * 2 // 3
        chroma = packed[:, :, h:].float().repeat_interleave(2, dim=2)
        chroma = chroma.repeat_interleave(2, dim=3)
        yuv = torch.stack([packed[:, :, :h].float(), chroma[..., :w],
                           chroma[..., w:]], dim=-1)
        yuv = yuv - torch.as_tensor(YUV_OFFSET, device=packed.device)
        m = YUV_TO_RGB.tolist()
        rgb = torch.stack([yuv[..., 0] * m[c][0] + yuv[..., 1] * m[c][1]
                           + yuv[..., 2] * m[c][2] for c in range(3)], -1)
        return torch.clamp(torch.round(rgb), 0.0, 255.0)

    def _norm_clip(self, frames):
        """uint8 frames -> normalized, in the model dtype. Frames at the
        CLIP size are normalized as they are; raw frames of another size
        are resized on the device first (shortest edge to the CLIP size,
        bicubic as `jax.image.resize`, center crop, rounded and clamped to
        [0, 255] as PIL's uint8 would be, `grove.py:115-146`); a 4-D uint8
        input is packed YUV420P. Non-uint8 input is taken as already
        normalized."""
        if frames.dtype != torch.uint8:
            return frames.to(self.dtype)
        size = self.cfg.clip.image_size
        if frames.ndim == 4:
            frames = self._yuv420_to_rgb(frames).to(torch.uint8)
        h, w = frames.shape[2:4]
        if (h, w) != (size, size):
            scale = size / min(h, w)
            nh, nw = round(h * scale), round(w * scale)
            xf = _resize_frames(frames, (nh, nw), "bicubic",
                                crop=((nh - size) // 2, (nw - size) // 2,
                                      size))
            frames = torch.round(torch.clamp(xf, 0.0, 255.0))
        dt = self.dtype
        mean = torch.as_tensor(CLIP_MEAN, device=frames.device, dtype=dt)
        std = torch.as_tensor(CLIP_STD, device=frames.device, dtype=dt)
        return (frames.to(dt) / 255.0 - mean) / std

    def _norm_sam(self, frames, valid_hw=None):
        """uint8 frames -> normalized. Frames at the SAM size: with
        `valid_hw` (B, 2) the padding outside each clip's valid region is
        re-zeroed, matching the reference's normalize-then-pad order. Raw
        frames of another size run ResizeLongestSide on the device
        (bilinear as `jax.image.resize`, rounded, normalized in fp32, then
        zero-padded bottom/right, `grove.py:148-183`); their valid region
        follows from the shape, so `valid_hw` is not read. A 4-D uint8
        input is packed YUV420P."""
        if frames.dtype != torch.uint8:
            return frames.to(self.dtype)
        size = self.cfg.sam_enc.img_size
        if frames.ndim == 4:
            frames = self._yuv420_to_rgb(frames).to(torch.uint8)
        dt = self.dtype
        h, w = frames.shape[2:4]
        if (h, w) != (size, size):
            scale = size / max(h, w)
            nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
            xf = _resize_frames(frames, (nh, nw), "bilinear")
            xf = torch.round(torch.clamp(xf, 0.0, 255.0))
            mean = torch.as_tensor(SAM_MEAN, device=frames.device)
            std = torch.as_tensor(SAM_STD, device=frames.device)
            xf = ((xf - mean) / std).to(dt)
            return F.pad(xf, (0, 0, 0, size - nw, 0, size - nh))
        mean = torch.as_tensor(SAM_MEAN, device=frames.device, dtype=dt)
        std = torch.as_tensor(SAM_STD, device=frames.device, dtype=dt)
        xf = (frames.to(dt) - mean) / std
        if valid_hw is not None:
            hh, ww = xf.shape[2:4]
            valid_hw = torch.as_tensor(valid_hw, device=xf.device)
            rows = torch.arange(hh, device=xf.device)[None, None, :, None]
            cols = torch.arange(ww, device=xf.device)[None, None, None, :]
            mask = ((rows < valid_hw[:, 0][:, None, None, None])
                    & (cols < valid_hw[:, 1][:, None, None, None]))
            xf = torch.where(mask[..., None], xf, torch.zeros_like(xf))
        return xf

    def encode_video(self, frames_clip):
        """CLIP tower + mm_projector -> ((B, N_video, D), mlvl features).

        The tower runs under `torch.no_grad()` unless
        `cfg.train_clip_adapters` is set: the JAX package's `stop_gradient`
        on its tokens (`grove.py:185-200`) and the reference's
        `@torch.no_grad` (`clip_encoder.py:55`). Gradients then reach the
        projector only, and the tower keeps no activations for a
        backward."""
        frames = self._norm_clip(frames_clip)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.cfg.train_clip_adapters):
            tokens, mlvl = self.model.vision_tower(frames)
        proj = self.model.mm_projector
        x = F.gelu(proj[0](tokens))                      # exact erf GELU
        return proj[2](x), mlvl

    def encode_grounding(self, frames_sam, valid_hw=None):
        """SAM encoder -> (B*T, HW, C_dec) flattened frame embeddings."""
        feat = self.model.grounding_encoder.image_encoder(
            self._norm_sam(frames_sam, valid_hw))
        bt, g, _, c = feat.shape
        return feat.reshape(bt, g * g, c)

    def encode_grounding_auto(self, frames_sam, valid_hw=None,
                              max_frames: int = 128):
        """`encode_grounding` in batch chunks of at most `max_frames`
        frames (the JAX `infer/jit_utils.encode_grounding_auto`)."""
        extras = () if valid_hw is None else (
            torch.as_tensor(valid_hw, device=frames_sam.device),)
        return encode_frames_chunked(self.encode_grounding, frames_sam,
                                     *extras, max_frames=max_frames)

    def dense_pe(self):
        return self.model.grounding_encoder.prompt_encoder.get_dense_pe()

    def encode_regions(self, mlvl_feats, rois_norm, roi_batch_idx):
        """`<bbox>`-prompt region queries (`grove.py:212-218`, reference
        `llava_with_region_arch.py:114-125`). mlvl_feats: the CLIP levels
        of `encode_video`; rois_norm (N, 4) normalized xyxy;
        roi_batch_idx (N,) frame of each RoI. Returns (N, D)."""
        return self.model.region_encoder(mlvl_feats, rois_norm,
                                         roi_batch_idx)

    def splice_regions(self, embeds, input_ids, region_embeds):
        """Token embeddings (B, L, D) with the k-th `<bbox>` token of row b
        replaced by region_embeds[b, k] (B, R, D), k clamped to R - 1
        (`grove.py:220-239`, reference `llava_with_region_arch.py:
        333-347`)."""
        ids = torch.as_tensor(input_ids, device=embeds.device)
        is_bbox = ids == self.cfg.tokens.bbox
        occ = (torch.cumsum(is_bbox.long(), dim=1) - 1).clamp(
            0, region_embeds.shape[1] - 1)
        gathered = torch.gather(region_embeds, 1, occ[..., None].expand(
            -1, -1, region_embeds.shape[-1]))
        return torch.where(is_bbox[..., None], gathered.to(embeds.dtype),
                           embeds)

    # ------------------------------------------------------------------
    # language model
    # ------------------------------------------------------------------

    def _splice(self, input_ids, video_embeds, video_start):
        """Token embeddings with each row's video features written at its
        `video_start` (rows with start < 0 keep their tokens). The start is
        clamped so the run fits, like `lax.dynamic_update_slice`."""
        embeds = self.model.embed_tokens(input_ids)     # (B, Ls, D)
        if embeds._base is not None:
            # a vocab-parallel embedding hands back a view of its reduced
            # DTensor, which autograd forbids writing in place
            embeds = embeds.clone()
        ls, n = embeds.shape[1], video_embeds.shape[1]
        starts = [int(s) for s in torch.as_tensor(video_start).tolist()]
        for row, start in enumerate(starts):
            if start >= 0:
                s = min(start, ls - n)
                embeds[row, s:s + n] = video_embeds[row].to(embeds.dtype)
        return embeds

    def _lm_hidden(self, input_ids, video_embeds, video_start,
                   attn_mask=None):
        x = self._splice(input_ids, video_embeds, video_start)
        positions = torch.arange(input_ids.shape[1],
                                 device=x.device)[None].expand(
                                     input_ids.shape[0], -1)
        return self.model(x, positions, attn_mask=attn_mask)

    def lm_forward(self, input_ids, video_embeds, video_start,
                   attn_mask=None):
        """Full-sequence LM pass -> (hidden post-norm, logits)."""
        hidden = self._lm_hidden(input_ids, video_embeds, video_start,
                                 attn_mask)
        return hidden, self.lm_head(hidden)

    def prefill(self, input_ids, video_embeds, video_start, kv_caches,
                pad_lens=None):
        """Prompt pass writing the KV cache. Unequal prompts arrive
        LEFT-padded with `pad_lens` (B,): pad slots are masked and RoPE
        positions start at each sample's true start."""
        x = self._splice(input_ids, video_embeds, video_start)
        b, ls = input_ids.shape
        positions = torch.arange(ls, device=x.device)[None].expand(b, -1)
        if pad_lens is not None:
            positions = torch.clamp(positions - pad_lens[:, None], min=0)
        hidden = self.model(x, positions, kv_caches, 0, pad_lens=pad_lens)
        return hidden, self.lm_head(hidden[:, -1:]), kv_caches

    def decode_step(self, token, pos: int, kv_caches, pad_lens=None):
        """One greedy step. token: (B, 1) ids; pos: the cache slot."""
        x = self.model.embed_tokens(token)
        positions = torch.full(token.shape, pos, device=x.device,
                               dtype=torch.long)
        if pad_lens is not None:
            positions = positions - pad_lens[:, None]
        hidden = self.model(x, positions, kv_caches, pos, pad_lens=pad_lens)
        return hidden, self.lm_head(hidden), kv_caches

    # ------------------------------------------------------------------
    # grounding head
    # ------------------------------------------------------------------

    def ground(self, hidden, det_positions, image_embeddings):
        """hidden (B, L, D), det_positions (B, P), image_embeddings
        (B*T, HW, C) -> boxes (B, T, P, 4), objectness logits (B, T, P).
        The per-phrase gather runs before the projection MLP (pointwise, so
        the same numbers for P << L rows)."""
        cfg = self.cfg
        b, _, d = hidden.shape
        p = det_positions.shape[1]
        t = image_embeddings.shape[0] // b
        idx = det_positions.long().to(hidden.device)
        gathered = torch.gather(hidden, 1, idx[..., None].expand(b, p, d))
        pred = self.model.text_hidden_fcs[0](gathered)  # (B, P, out_dim)

        pe = self.model.grounding_encoder.prompt_encoder
        sparse, dense = pe(text_embeds=pred.reshape(b * p, 1, cfg.out_dim))
        c = sparse.shape[-1]
        sparse = sparse.reshape(b, 1, p, 1, c).expand(b, t, p, 1, c)
        sparse = sparse.reshape(b * t * p, 1, c)
        hw = image_embeddings.shape[1]
        src = image_embeddings[:, None].expand(b * t, p, hw, c)
        src = src.reshape(b * t * p, hw, c)
        boxes, obj = self.model.grounding_encoder.mask_decoder(
            src, self.dense_pe(), sparse, dense)
        boxes = boxes.reshape(b, t, p, 4)
        if obj is not None:
            obj = obj.reshape(b, t, p)
        return boxes, obj

    def segment(self, image_embeddings, *, points=None, point_labels=None,
                boxes=None, mask_inputs=None, multimask_output=False):
        """SAM-style promptable segmentation (`grove.py:370-386`, the
        reference's legacy mask path). image_embeddings (N, HW, C) from
        `encode_grounding`, one prompt per row: points (N, K, 2) pixel xy
        with point_labels (N, K), boxes (N, 4) xyxy pixels, mask_inputs
        (N, 4g, 4g, 1). Returns (masks (N, M, 4g, 4g) logits, iou
        predictions (N, M)), M = 3 with `multimask_output`, else 1."""
        sam = self.model.grounding_encoder
        sparse, dense = sam.prompt_encoder(
            points=points, point_labels=point_labels, boxes=boxes,
            masks=mask_inputs)
        return sam.mask_decoder.predict_masks(
            image_embeddings, self.dense_pe(), sparse, dense,
            multimask_output=multimask_output)

    def forward_boxes(self, batch: Dict[str, torch.Tensor]):
        """Teacher-forced boxes + objectness logits (reference
        model_forward(inference=True)); thresholding is host-side."""
        video_embeds, _ = self.encode_video(batch["frames_clip"])
        image_embeddings = self.encode_grounding(batch["frames_sam"],
                                                 batch.get("sam_valid_hw"))
        hidden = self._lm_hidden(batch["input_ids"], video_embeds,
                                 batch["video_start"])
        boxes, obj = self.ground(hidden, batch["det_positions"],
                                 image_embeddings)
        return {"pred_boxes": boxes, "objectness_logits": obj}

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      count_reduce=None):
        """Training forward -> the loss dict of `ops.losses.
        grove_total_loss` (`grove.py:352-368`, the reference's
        model_forward train path). `count_reduce`: see `ops.losses`."""
        video_embeds, _ = self.encode_video(batch["frames_clip"])
        image_embeddings = self.encode_grounding(batch["frames_sam"],
                                                 batch.get("sam_valid_hw"))
        hidden, logits = self.lm_forward(batch["input_ids"], video_embeds,
                                         batch["video_start"])
        return self.losses(batch, hidden, logits, image_embeddings,
                           count_reduce)

    def losses(self, batch, hidden, logits, image_embeddings,
               count_reduce=None):
        """`ground` on the LM's hidden states, then the loss dict against
        the batch's targets (the tail of `forward_train`, shared with the
        pipelined step)."""
        cfg = self.cfg
        boxes, obj = self.ground(hidden, batch["det_positions"],
                                 image_embeddings)
        return grove_total_loss(
            logits, batch["labels"], boxes, obj, batch["gt_boxes"],
            batch["gt_objectness"], batch["phrase_mask"],
            ce_weight=cfg.ce_loss_weight, giou_weight=cfg.giou_loss_weight,
            objectness_weight=cfg.temp_objectness_loss_weight,
            use_temp_objectness=cfg.use_temp_objectness,
            ignore_index=cfg.tokens.ignore_index, count_reduce=count_reduce)


# ---------------------------------------------------------------------------
# random initialization (synthetic weights from a seed)
# ---------------------------------------------------------------------------

_ONES = (nn.LayerNorm, nn.GroupNorm)
_STD_BY_NAME = {
    "class_embedding": 0.02, "position_embedding.weight": 0.02,
    "embed_tokens.weight": 0.02, "pos_embed": 0.02, "rel_pos_h": 0.02,
    "rel_pos_w": 0.02, "positional_encoding_gaussian_matrix": 1.0,
}


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator`, in place: lecun-normal
    weights for linear and conv layers (the flax default), unit norm
    scales, zero biases, N(0, 0.02) position and token tables, N(0, 1)
    prompt tokens; LoRA's `lora_A` N(0, 0.01) and `lora_B` zero, the JAX
    initializers. Adapter gates get alpha = 0.1 instead of the reference's
    zero so the random-weight model runs its Conv3d adapters. Values are
    drawn in fp32 on the parameter's device and cast. Quantized linears get
    the JAX init's placeholders (zero kernels, unit scales); random
    quantized weights come from quantizing random float ones
    (`ops.quant.quantize_llama_`, `quantize_vision_`)."""
    from .layers import LayerNorm2d, LayerNormQuant, RMSNorm

    def randn(p, std):
        # a tensor left on the meta device still takes its draws
        x = torch.randn(p.shape, generator=generator,
                        device=generator.device if p.is_meta else p.device,
                        dtype=torch.float32)
        if not p.is_meta:
            p.copy_(x * std)

    for mname, mod in model.named_modules():
        if hasattr(mod, "reset_placeholders_"):
            mod.reset_placeholders_()
        for pname, p in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            if full.endswith("lora_A.weight"):
                randn(p, 0.01)                  # `llama.py:108`
            elif full.endswith("lora_B.weight"):
                p.zero_()                       # `llama.py:111`
            elif pname == "alpha":
                p.fill_(0.1)
            elif pname == "bias":
                p.zero_()
            elif isinstance(mod, _ONES + (LayerNorm2d, LayerNormQuant,
                                          RMSNorm)):
                p.fill_(1.0)
            elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                fan_in = p[0].numel()
                randn(p, fan_in ** -0.5)
            elif isinstance(mod, nn.ConvTranspose2d):
                randn(p, (p.shape[0] * p[0, 0].numel()) ** -0.5)
            else:
                std = next((s for k, s in _STD_BY_NAME.items()
                            if full.endswith(k)), 1.0)
                randn(p, std)
    return model


def init_grove_params(cfg: GroveConfig, *, device, dtype=torch.bfloat16,
                      seed: int = 0, remat: bool = False,
                      llm_act_sharding=None, layers=None) -> GroveModel:
    """Build a GroveModel with synthetic weights from `seed`, directly on
    `device` in `dtype`: the modules are made on the meta device, given
    uninitialized storage on `device`, then filled by `init_params_` with
    a generator on that device (no fp32 copy of the model ever exists).
    `remat` and `llm_act_sharding` as `GroveModel`'s
    (`grove.py:424-425`). `layers`: None, or the decoder layers to hold
    (a pipeline stage's, `parallel.pipeline.stage_layers`): the others
    stay on the meta device, with no storage, and their draws are made
    and dropped, so that every tensor held equals the whole model's."""
    model = GroveModel(cfg, remat=remat, device="meta", dtype=dtype,
                       llm_act_sharding=llm_act_sharding)
    if layers is None:
        model = model.to_empty(device=device)
    else:
        dropped = tuple(f"model.layers.{i}."
                        for i in range(cfg.llama.num_layers)
                        if i not in set(layers))
        for name, mod in model.named_modules():
            if not f"{name}.".startswith(dropped):
                mod.to_empty(device=device, recurse=False)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_params_(model, gen)
    return model.eval()
