"""GROVE top-level model: grounded video caption generation, inference in
bf16 or with the quantized serving modules (`ops.quant`).

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

Static-shape contract as in the JAX package:
  frames_clip  (B, T, Hc, Wc, 3) uint8 at the CLIP size, or normalized
  frames_sam   (B, T, Hs, Ws, 3) uint8 at the SAM size, or normalized
  input_ids    (B, Ls) spliced ids; video_start (B,); det_positions (B, P)
  boxes out    (B, T, P, 4) cxcywh in [0, 1]; objectness logits (B, T, P)

Not ported yet (they raise): the raw-frame resize and the packed YUV420
input of `_norm_clip`/`_norm_sam` (`jax.image.resize` bicubic differs from
`F.interpolate` in antialiasing and cubic coefficient: its own PR), the
region encoder, and the legacy SAM mask path.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from grove_tpu.config import GroveConfig

from ..data.preprocess import CLIP_MEAN, CLIP_STD, SAM_MEAN, SAM_STD
from .clip import ClipVisionTower
from .llama import LlamaModel, _dense
from .region import MLVLROIQueryModule
from .sam_decoder import GroveBoxDecoder, PromptEncoder
from .sam_encoder import SamImageEncoder, encode_frames_chunked

_RAW_INPUT = ("raw-frame resize and packed YUV420 input are not ported yet: "
              "pass uint8 frames already at the tower's size (ROADMAP "
              "Queue 1 item 3)")


class SamGrounding(nn.Module):
    """The reference's `Sam` container (`grounding_encoder`)."""

    def __init__(self, cfg: GroveConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.image_encoder = SamImageEncoder(cfg.sam_enc, **f)
        self.prompt_encoder = PromptEncoder(cfg.sam_dec, **f)
        self.mask_decoder = GroveBoxDecoder(cfg.sam_dec, **f)


class GroveBackbone(LlamaModel):
    """`model.*`: the LLaMA model plus the multimodal modules, as in the
    reference's LlavaLlamaModel subclass."""

    def __init__(self, cfg: GroveConfig, *, device=None, dtype=None):
        f = dict(device=device, dtype=dtype)
        super().__init__(cfg.llama, **f)
        d = cfg.llama.hidden_size
        self.vision_tower = ClipVisionTower(
            cfg.clip, (cfg.pool_t, cfg.pool_h, cfg.pool_w), **f)
        self.mm_projector = nn.Sequential(
            nn.Linear(cfg.clip.hidden_size, d, **f), nn.GELU(),
            nn.Linear(d, d, **f))
        self.grounding_encoder = SamGrounding(cfg, **f)
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
    def __init__(self, cfg: GroveConfig, *, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.model = GroveBackbone(cfg, device=device, dtype=dtype)
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

    def _norm_clip(self, frames):
        """uint8 frames at the CLIP size -> normalized, in the model dtype.
        Non-uint8 input is taken as already normalized."""
        if frames.dtype != torch.uint8:
            return frames.to(self.dtype)
        size = self.cfg.clip.image_size
        if frames.ndim != 5 or tuple(frames.shape[2:4]) != (size, size):
            raise NotImplementedError(_RAW_INPUT)
        dt = self.dtype
        mean = torch.as_tensor(CLIP_MEAN, device=frames.device, dtype=dt)
        std = torch.as_tensor(CLIP_STD, device=frames.device, dtype=dt)
        return (frames.to(dt) / 255.0 - mean) / std

    def _norm_sam(self, frames, valid_hw=None):
        """uint8 frames at the SAM size -> normalized; with `valid_hw`
        (B, 2) the padding outside each clip's valid region is re-zeroed,
        matching the reference's normalize-then-pad order."""
        if frames.dtype != torch.uint8:
            return frames.to(self.dtype)
        size = self.cfg.sam_enc.img_size
        if frames.ndim != 5 or tuple(frames.shape[2:4]) != (size, size):
            raise NotImplementedError(_RAW_INPUT)
        dt = self.dtype
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
        """CLIP tower + mm_projector -> ((B, N_video, D), mlvl features)."""
        tokens, mlvl = self.model.vision_tower(self._norm_clip(frames_clip))
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
        return self.model.region_encoder(mlvl_feats, rois_norm,
                                         roi_batch_idx)

    # ------------------------------------------------------------------
    # language model
    # ------------------------------------------------------------------

    def _splice(self, input_ids, video_embeds, video_start):
        """Token embeddings with each row's video features written at its
        `video_start` (rows with start < 0 keep their tokens). The start is
        clamped so the run fits, like `lax.dynamic_update_slice`."""
        embeds = self.model.embed_tokens(input_ids)     # (B, Ls, D)
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
    prompt tokens. Adapter gates get alpha = 0.1 instead of the reference's
    zero so the random-weight model runs its Conv3d adapters. Values are
    drawn in fp32 on the parameter's device and cast. Quantized linears get
    the JAX init's placeholders (zero kernels, unit scales); random
    quantized weights come from quantizing random float ones
    (`ops.quant.quantize_llama_`, `quantize_vision_`)."""
    from .layers import LayerNorm2d, LayerNormQuant, RMSNorm

    def randn(p, std):
        x = torch.randn(p.shape, generator=generator, device=p.device,
                        dtype=torch.float32)
        p.copy_(x * std)

    for mname, mod in model.named_modules():
        if hasattr(mod, "reset_placeholders_"):
            mod.reset_placeholders_()
        for pname, p in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            if pname == "alpha":
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
                      seed: int = 0) -> GroveModel:
    """Build a GroveModel with synthetic weights from `seed`, directly on
    `device` in `dtype`: the modules are made on the meta device, given
    uninitialized storage on `device`, then filled by `init_params_` with
    a generator on that device (no fp32 copy of the model ever exists)."""
    model = GroveModel(cfg, device="meta", dtype=dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_params_(model, gen)
    return model.eval()
