"""SAM ViTDet-style grounding image encoder.

Counterpart of `grove_tpu/models/sam_encoder.py` (reference
`model/SAM/modeling/image_encoder.py`, ViT-H: windowed attention with 4
global blocks, decomposed rel-pos, conv neck) plus GROVE's gated Conv3d
adapter after each global block. Activations stay channels-last
(B*T, H, W, C) as in the JAX package.

* Windowed blocks: `window_partition` zero-pads the 32 x 32 grid to 42 x 42
  (9 windows of 14 x 14 per frame). The pad tokens go through qkv and are
  NOT masked out of the attention, as in the reference. Attention is K1 on
  the unsplit qkv (`ops.sam_attention.sam_window_attention_fused`).
* Global blocks: K2 over the full grid (`sam_attention_with_relpos`).
* The neck runs in fp32 like the reference's overflow guard.

With `cfg.quant_w8a8` (the W8A8 tower, `ops.quant.quantize_sam_` or a
quantized config) the blocks follow `sam_encoder.py:120-270`: the norms are
`LayerNormQuant`s that hand int8 activations to qkv and lin1, so the window
partition moves int8 bytes; with static scales (`quant_static_act`) the
windowed attention is K1q, which writes proj's int8 input directly, and
every residual add happens inside the next norm's K8b: a block returns its
MLP branch un-added, and the sum is materialized only after each global
block (the adapter needs it) and before the neck. Patch embedding, position
embeddings, adapters' gates and the neck stay float.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SamEncoderConfig
from ..ops.attention import xla_attention
from ..ops.sam_attention import (sam_attention_with_relpos,
                                 sam_window_attention_fused,
                                 sam_window_attention_fused_q8)
from .layers import (Int8Linear, LayerNorm2d, LayerNormQuant, MLPBlock,
                     SpatioTemporalConvAdapter, quant_act, quant_act_static,
                     record_absmax, remat_call)


def window_partition(x, window: int):
    """(B, H, W, C) -> (B*nW, win, win, C) with zero padding; returns the
    padded (hp, wp)."""
    b, h, w, c = x.shape
    pad_h = (-h) % window
    pad_w = (-w) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(windows, window: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // ((hp * wp) // (window * window))
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class SamAttention(nn.Module):
    """ViTDet attention. In W8A8 (`w8a8`) qkv and proj are `Int8Linear`s
    and the module owns `proj_act_scale`, the calibrated scale of proj's
    input; `static_act` selects the static path (`sam_encoder.py:100-229`)."""

    def __init__(self, cfg: SamEncoderConfig, input_size: int,
                 window: int = 0, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        c = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.window = window
        self.use_rel_pos = cfg.use_rel_pos
        self.static_act = cfg.quant_static_act
        if cfg.quant_w8a8:
            q = dict(bias=True, act_quant=True,
                     static_act=cfg.quant_static_act, **f)
            self.qkv = Int8Linear(c, 3 * c, **q)
            self.proj = Int8Linear(c, c, **q)
            self.register_buffer("proj_act_scale", torch.ones(
                (), dtype=torch.float32, device=device))
        else:
            self.qkv = nn.Linear(c, 3 * c, **f)
            self.proj = nn.Linear(c, c, **f)
        if cfg.use_rel_pos:
            hd = c // cfg.num_heads
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * input_size - 1, hd, **f))
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * input_size - 1, hd, **f))

    @property
    def w8a8(self) -> bool:
        return isinstance(self.qkv, Int8Linear)

    @torch.no_grad()
    def reset_placeholders_(self):
        if self.w8a8 and not self.proj_act_scale.is_meta:
            self.proj_act_scale.fill_(1.0)

    def forward(self, x, sx=None):          # (B, H, W, C); int8 + sx in W8A8
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        win = self.window
        if self.w8a8 and sx is None:
            x, sx = quant_act(x)            # standalone use, no LN producer
        if win > 0:
            x, pad_hw = window_partition(x, win)        # (nW, win, win, C)
            if sx is not None and sx.dim() > 0:
                sx, _ = window_partition(sx, win)
            nb, s, hw = x.shape[0], win * win, (win, win)
        else:
            nb, s, hw = b, h * w, (h, w)
        if sx is None:
            qkv = self.qkv(x.reshape(nb, s, c))         # (nb, S, 3C)
        else:
            qkv = self.qkv(x.reshape(nb, s, c),
                           sx if sx.dim() == 0 else sx.reshape(nb, s, 1))

        static = self.w8a8 and self.static_act
        out_q8 = None                       # proj's int8 input, from K1q
        if self.use_rel_pos and win > 0:
            if static:
                out_q8 = sam_window_attention_fused_q8(
                    qkv, self.rel_pos_h, self.rel_pos_w, hw, nh,
                    self.proj_act_scale)
                out = out_q8
            else:
                out = sam_window_attention_fused(qkv, self.rel_pos_h,
                                                 self.rel_pos_w, hw, nh)
        else:
            q, k, v = (t.reshape(nb, s, nh, hd).contiguous()
                       for t in qkv.split(c, dim=-1))
            if self.use_rel_pos:
                out = sam_attention_with_relpos(q, k, v, self.rel_pos_h,
                                                self.rel_pos_w, hw)
            else:
                out = xla_attention(q, k, v)
            out = out.reshape(nb, s, c)

        if win > 0:
            out = window_unpartition(out.reshape(nb, win, win, c), win,
                                     pad_hw, (h, w))
        out = out.reshape(b, h * w, c)
        if not self.w8a8:
            return self.proj(out).reshape(b, h, w, c)
        if out_q8 is not None:
            out = self.proj(out, self.proj_act_scale)
        elif static:
            xq, _ = quant_act_static(out, self.proj_act_scale)
            out = self.proj(xq, self.proj_act_scale)
        else:
            # dynamic serving and the calibration pass: this module owns
            # the stat, so proj never re-quantizes
            record_absmax(self, "proj_absmax", out)
            out = self.proj(*quant_act(out))
        return out.reshape(b, h, w, c)


class SamBlock(nn.Module):
    def __init__(self, cfg: SamEncoderConfig, window_size: int, *,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        c = cfg.embed_dim
        if cfg.quant_w8a8:
            q = dict(static_act=cfg.quant_static_act,
                     use_kernel=cfg.quant_ln_kernel, **f)
            self.norm1 = LayerNormQuant(c, cfg.layer_norm_eps, **q)
            self.norm2 = LayerNormQuant(c, cfg.layer_norm_eps, **q)
        else:
            self.norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps, **f)
            self.norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps, **f)
        self.attn = SamAttention(cfg, input_size=window_size or cfg.grid,
                                 window=window_size, **f)
        self.mlp = MLPBlock(c, int(c * cfg.mlp_ratio), w8a8=cfg.quant_w8a8,
                            static_act=cfg.quant_static_act, **f)

    def forward(self, x, branch=None):
        """bf16: the reference dataflow. W8A8: takes the previous block's
        un-added MLP branch and returns (resid, this block's MLP branch),
        so each residual add runs inside a norm (`sam_encoder.py:237-270`)."""
        if not isinstance(self.norm1, LayerNormQuant):
            x = x + self.attn(self.norm1(x))
            return x + self.mlp(self.norm2(x))
        if branch is None:
            xq, sx = self.norm1(x)
        else:
            x, xq, sx = self.norm1(x, branch)
        x, hq, s2 = self.norm2(x, self.attn(xq, sx))
        return x, self.mlp(hq, s2)


class SamPatchEmbed(nn.Module):
    def __init__(self, cfg: SamEncoderConfig, *, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size, device=device,
                              dtype=dtype)

    def forward(self, x):                               # (N, H, W, 3)
        return self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SamImageEncoder(nn.Module):
    """frames (B, T, H, W, 3) -> (B*T, g, g, out_chans), NHWC. With
    `remat` each block runs under `torch.utils.checkpoint` when gradients
    are on (`sam_encoder.py:337`)."""

    def __init__(self, cfg: SamEncoderConfig, *, remat: bool = False,
                 device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.remat = remat
        g, c = cfg.grid, cfg.embed_dim
        self.patch_embed = SamPatchEmbed(cfg, **f)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, c, **f))
        self.blocks = nn.ModuleList(
            SamBlock(cfg, 0 if i in cfg.global_attn_indexes
                     else cfg.window_size, **f)
            for i in range(cfg.depth))
        self.adapters = nn.ModuleList(
            SpatioTemporalConvAdapter(c, w8a8=cfg.quant_w8a8,
                                      static_act=cfg.quant_static_act, **f)
            for _ in cfg.global_attn_indexes)
        oc = cfg.out_chans
        self.neck = nn.Sequential(
            nn.Conv2d(c, oc, 1, bias=False, **f),
            LayerNorm2d(oc, **f),
            nn.Conv2d(oc, oc, 3, padding=1, bias=False, **f),
            LayerNorm2d(oc, **f))

    def forward(self, frames):
        cfg = self.cfg
        b, t, hh, ww, _ = frames.shape
        x = self.patch_embed(frames.reshape(b * t, hh, ww, 3))
        x = x + self.pos_embed.to(x.dtype)
        n_adapter = 0
        branch = None                   # W8A8: the pending un-added branch
        for i, blk in enumerate(self.blocks):
            is_global = i in cfg.global_attn_indexes
            if cfg.quant_w8a8:
                x, branch = remat_call(self.remat, blk, x, branch)
                if is_global:           # the adapter needs the sum
                    x, branch = x + branch, None
            else:
                x = remat_call(self.remat, blk, x)
            if is_global:
                g = cfg.grid
                grid5 = x.reshape(b, t, g, g, cfg.embed_dim)
                grid5 = self.adapters[n_adapter](grid5)
                x = grid5.reshape(b * t, g, g, cfg.embed_dim)
                n_adapter += 1
        if branch is not None:
            x = x + branch
        # neck in fp32 (the reference guards against fp16 overflow here)
        xf = x.float().permute(0, 3, 1, 2)
        xf = F.conv2d(xf, self.neck[0].weight.float())
        xf = self.neck[1](xf)
        xf = F.conv2d(xf, self.neck[2].weight.float(), padding=1)
        xf = self.neck[3](xf)
        return xf.permute(0, 2, 3, 1).to(x.dtype)


def encode_frames_chunked(encoder, frames, *extras, max_frames: int = 128):
    """Run `encoder(frames, *extras)` over (B, T, ...) frames in the fewest
    batch chunks that keep each call at or below `max_frames` frames and
    divide B evenly: the chunk picker of the JAX
    `infer/jit_utils.py:encode_grounding_auto`, as a plain loop. `extras`
    are per-clip (B, ...) tensors cut alongside; `encoder` maps
    (b, T, ...) -> (b*T, ...)."""
    b, t = frames.shape[:2]
    nch = 1
    while ((b + nch - 1) // nch) * t > max_frames or b % nch:
        nch += 1
        if nch >= b:
            nch = b
            break
    if nch <= 1:
        return encoder(frames, *extras)
    step = b // nch
    return torch.cat([encoder(frames[i:i + step],
                              *(e[i:i + step] for e in extras))
                      for i in range(0, b, step)], dim=0)
