"""CLIP ViT vision tower with video adapters and 3-D pooling.

Counterpart of `grove_tpu/models/clip.py`, with the module tree of the
reference's HF CLIP (`model.vision_tower.vision_tower.vision_model.*`):

* pre-layernorm ViT (cls + patch tokens, learned position embeddings);
* a zero-init gated Conv3d adapter after every `adapter_every`-th layer
  (idx % 3 == 0) on the patch tokens, with the reference's reshape quirk:
  576 tokens as (t, adapter_h = 16, 36), not the 24 x 24 grid
  (`config.py:30-33`, `modeling_clip.py:604`);
* features of hidden-states layer `select_layer` (-2) without the cls token;
* AdaptiveAvgPool3d over (t, h, w) -> 576 video tokens.

Self-attention goes through `ops.attention.multi_head_attention`, i.e. K3 on
the card.

With `cfg.quant_w8a8` (the W8A8 tower, `ops.quant.quantize_clip_` or a
quantized config; `clip.py:41-137`): `layer_norm1` / `layer_norm2` are
`LayerNormQuant`s whose int8 output feeds q/k/v_proj and fc1 (one quantize
for the three projections), out_proj and fc2 quantize their own inputs, and
the adapters' conv is `Int8Conv3d`. Attention stays K3 in the compute
dtype; the embeddings, `pre_layrnorm` and the pooling stay float.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from grove_tpu.config import ClipVisionConfig

from ..ops.attention import multi_head_attention
from .layers import (Int8Linear, LayerNormQuant, SpatioTemporalConvAdapter,
                     adaptive_avg_pool_3d)


def _linear(cfg: ClipVisionConfig, k: int, n: int, f, act_site=False):
    """nn.Linear, or the W8A8 `Int8Linear` of a quantized tower (the JAX
    `_dense` factory, `clip.py:41-49`)."""
    if cfg.quant_w8a8:
        return Int8Linear(k, n, bias=True, act_quant=True, act_site=act_site,
                          static_act=cfg.quant_static_act, **f)
    return nn.Linear(k, n, **f)


def _norm(cfg: ClipVisionConfig, f):
    if cfg.quant_w8a8:
        return LayerNormQuant(cfg.hidden_size, cfg.layer_norm_eps,
                              static_act=cfg.quant_static_act,
                              use_kernel=cfg.quant_ln_kernel, **f)
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **f)


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device=None, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        f = dict(device=device, dtype=dtype)
        self.num_heads = cfg.num_heads
        self.q_proj = _linear(cfg, d, d, f)
        self.k_proj = _linear(cfg, d, d, f)
        self.v_proj = _linear(cfg, d, d, f)
        self.out_proj = _linear(cfg, d, d, f, act_site=True)

    def forward(self, x, sx=None):          # int8 x + sx in W8A8
        b, s, d = x.shape
        hd = d // self.num_heads
        xs = (x,) if sx is None else (x, sx)
        q = self.q_proj(*xs).reshape(b, s, self.num_heads, hd)
        k = self.k_proj(*xs).reshape(b, s, self.num_heads, hd)
        v = self.v_proj(*xs).reshape(b, s, self.num_heads, hd)
        out = multi_head_attention(q, k, v)
        return self.out_proj(out.reshape(b, s, d))


class ClipMLP(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.fc1 = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, f)
        self.fc2 = _linear(cfg, cfg.intermediate_size, cfg.hidden_size, f,
                           act_site=True)

    def forward(self, x, sx=None):
        h = self.fc1(x) if sx is None else self.fc1(x, sx)
        return self.fc2(h * torch.sigmoid(1.702 * h))   # OpenAI quick_gelu


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.self_attn = ClipAttention(cfg, **f)
        self.layer_norm1 = _norm(cfg, f)
        self.mlp = ClipMLP(cfg, **f)
        self.layer_norm2 = _norm(cfg, f)

    def forward(self, x):
        """The norms hand (int8, scale) to the projections in W8A8, the
        float activations otherwise."""
        x = x + self.self_attn(*_tuple(self.layer_norm1(x)))
        return x + self.mlp(*_tuple(self.layer_norm2(x)))


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


class ClipEmbeddings(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.class_embedding = nn.Parameter(
            torch.zeros(cfg.hidden_size, **f))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False,
                                         **f)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1,
                                               cfg.hidden_size, **f)

    def forward(self, x):                               # (N, H, W, 3)
        n = x.shape[0]
        patches = self.patch_embedding(x.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)    # (N, P, C)
        cls_tok = self.class_embedding.to(x.dtype).expand(n, 1, -1)
        x = torch.cat([cls_tok, patches], dim=1)
        return x + self.position_embedding.weight.to(x.dtype)[None]


class ClipEncoder(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(ClipEncoderLayer(cfg, **f)
                                    for _ in range(cfg.num_layers))
        # one adapter after each layer i with i % adapter_every == 0 (the
        # JAX tower's count; `cfg.num_adapters` rounds down instead)
        self.adapters = nn.ModuleList(
            SpatioTemporalConvAdapter(cfg.hidden_size, w8a8=cfg.quant_w8a8,
                                      static_act=cfg.quant_static_act, **f)
            for _ in range(0, cfg.num_layers, cfg.adapter_every))


class ClipVisionTransformer(nn.Module):
    """embeddings -> pre_layrnorm (HF's spelling, kept) -> encoder with
    adapters -> select / pool."""

    def __init__(self, cfg: ClipVisionConfig,
                 pool_thw: Tuple[int, int, int], num_region_levels: int = 4,
                 *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.pool_thw = tuple(pool_thw)
        self.num_region_levels = num_region_levels
        self.embeddings = ClipEmbeddings(cfg, **f)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps, **f)
        self.encoder = ClipEncoder(cfg, **f)

    def _adapter(self, x, adapter):
        """(b*t, 1+P, c): the adapter sees the patch tokens as
        (b, t, adapter_h, P / adapter_h, c)."""
        cfg = self.cfg
        cls_tok, seq = x[:, :1], x[:, 1:]
        bt, p, c = seq.shape
        t = cfg.num_frames
        grid = seq.reshape(bt // t, t, cfg.adapter_h, p // cfg.adapter_h, c)
        seq = adapter(grid).reshape(bt, p, c)
        return torch.cat([cls_tok, seq], dim=1)

    def forward(self, frames):
        """frames (B, T, H, W, 3), normalized -> (video_tokens (B, N, C),
        mlvl patch features of layers [-11, -8, -5, -2])."""
        cfg = self.cfg
        b, t, hh, ww, _ = frames.shape
        x = frames.reshape(b * t, hh, ww, 3)
        x = self.pre_layrnorm(self.embeddings(x))
        hidden_states: List[torch.Tensor] = [x]
        for i, layer in enumerate(self.encoder.layers):
            x = layer(x)
            if i % cfg.adapter_every == 0:
                adapter = self.encoder.adapters[i // cfg.adapter_every]
                x = self._adapter(x, adapter)
            hidden_states.append(x)

        feats = hidden_states[cfg.select_layer][:, 1:]  # (b*t, P, C)
        g = cfg.grid
        vol = feats.reshape(b, t, g, g, cfg.hidden_size)
        pooled = adaptive_avg_pool_3d(vol, self.pool_thw, axes=(1, 2, 3))
        pt, ph, pw = self.pool_thw
        video_tokens = pooled.reshape(b, pt * ph * pw, cfg.hidden_size)

        mlvl = hidden_states[cfg.select_layer::-cfg.adapter_every]
        mlvl = mlvl[::-1][-self.num_region_levels:]
        return video_tokens, tuple(h[:, 1:] for h in mlvl)


class ClipVisionModel(nn.Module):
    """HF `CLIPVisionModel` container (`vision_model`)."""

    def __init__(self, cfg, pool_thw, *, device=None, dtype=None):
        super().__init__()
        self.vision_model = ClipVisionTransformer(cfg, pool_thw,
                                                  device=device, dtype=dtype)

    def forward(self, frames):
        return self.vision_model(frames)


class ClipVisionTower(nn.Module):
    """The reference's `CLIPVisionTower` wrapper (`vision_tower`)."""

    def __init__(self, cfg, pool_thw, *, device=None, dtype=None):
        super().__init__()
        self.vision_tower = ClipVisionModel(cfg, pool_thw, device=device,
                                            dtype=dtype)

    def forward(self, frames):
        return self.vision_tower(frames)
