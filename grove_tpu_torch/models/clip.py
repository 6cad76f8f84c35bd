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
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from grove_tpu.config import ClipVisionConfig

from ..ops.attention import multi_head_attention
from .layers import (SpatioTemporalConvAdapter, adaptive_avg_pool_3d,
                     check_vision_config)


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device=None, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        f = dict(device=device, dtype=dtype)
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d, **f)
        self.k_proj = nn.Linear(d, d, **f)
        self.v_proj = nn.Linear(d, d, **f)
        self.out_proj = nn.Linear(d, d, **f)

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.num_heads
        q = self.q_proj(x).reshape(b, s, self.num_heads, hd)
        k = self.k_proj(x).reshape(b, s, self.num_heads, hd)
        v = self.v_proj(x).reshape(b, s, self.num_heads, hd)
        out = multi_head_attention(q, k, v)
        return self.out_proj(out.reshape(b, s, d))


class ClipMLP(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **f)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **f)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))   # OpenAI quick_gelu


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.self_attn = ClipAttention(cfg, **f)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps, **f)
        self.mlp = ClipMLP(cfg, **f)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps, **f)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


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
            SpatioTemporalConvAdapter(cfg.hidden_size, **f)
            for _ in range(0, cfg.num_layers, cfg.adapter_every))


class ClipVisionTransformer(nn.Module):
    """embeddings -> pre_layrnorm (HF's spelling, kept) -> encoder with
    adapters -> select / pool."""

    def __init__(self, cfg: ClipVisionConfig,
                 pool_thw: Tuple[int, int, int], num_region_levels: int = 4,
                 *, device=None, dtype=None):
        super().__init__()
        check_vision_config(cfg)
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
