"""LLaMA decoder, bf16 path, with an explicit KV cache.

Counterpart of `grove_tpu/models/llama.py` with the HF `LlamaModel` module
tree (`model.embed_tokens`, `model.layers.N.*`, `model.norm`):

* RoPE in HF's half-rotation convention, computed in fp32 exactly as
  `apply_rope` (`llama.py:74`) does;
* hidden states handed downstream are AFTER the final RMSNorm;
* the model consumes `inputs_embeds`; the video splice happens in
  `models.grove`.

Attention:
* no cache (teacher-forced pass): causal self-attention through
  `ops.attention.multi_head_attention`, i.e. K4 on the card;
* with the bf16 cache (prefill, decode): plain fp32-softmax attention over
  the whole cache with a causal mask, and for left-padded prompts a mask
  that drops the pad slots but keeps each row's own slot
  (`llama.py:292-297`): a fully masked row would softmax to NaN and poison
  later layers through its k/v.

The cache is a list of {"k", "v"} (B, C, H_kv, D) tensors, one per layer,
written IN PLACE at `cache_offset` (the JAX package returns updated copies).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from grove_tpu.config import LlamaConfig

from ..ops.attention import multi_head_attention, xla_attention
from .layers import RMSNorm


def check_bf16_config(cfg: LlamaConfig) -> None:
    """Raise for the LLaMA options this slice does not run."""
    if cfg.weight_quant or cfg.act_quant or cfg.fused_qkv:
        raise NotImplementedError(
            "LlamaConfig weight_quant / act_quant / fused_qkv: the quantized "
            "serving stack is not ported yet (ROADMAP Queue 1 item 11)")
    if cfg.lora_r > 0:
        raise NotImplementedError(
            "LlamaConfig.lora_r > 0: LoRA belongs to the training slice "
            "(ROADMAP Queue 1 item 14)")


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for HF-convention RoPE. positions: (B, S) or (S,)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, D); cos/sin: (B, S, D) or (S, D)."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def _repeat_kv(x: torch.Tensor, reps: int) -> torch.Tensor:
    """GQA: (B, S, H_kv, D) -> (B, S, H_kv * reps, D), each head repeated
    in place (jnp.repeat semantics)."""
    return x if reps == 1 else x.repeat_interleave(reps, dim=2)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype, bias=False)
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_heads * hd, **f)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, **f)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, **f)
        self.o_proj = nn.Linear(cfg.num_heads * hd, cfg.hidden_size, **f)

    def forward(self, x, positions, kv_cache: Optional[Dict] = None,
                cache_offset: int = 0, attn_mask=None, pad_lens=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        reps = cfg.num_heads // cfg.num_kv_heads
        q = self.q_proj(x).reshape(b, s, cfg.num_heads, hd)
        k = self.k_proj(x).reshape(b, s, cfg.num_kv_heads, hd)
        v = self.v_proj(x).reshape(b, s, cfg.num_kv_heads, hd)
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if kv_cache is None:
            # pure self-attention (teacher-forced inference)
            out = multi_head_attention(q, _repeat_kv(k, reps),
                                       _repeat_kv(v, reps), causal=True,
                                       mask=attn_mask)
        else:
            # write into the cache in place, attend over all of it
            ck, cv = kv_cache["k"], kv_cache["v"]
            ck[:, cache_offset:cache_offset + s] = k.to(ck.dtype)
            cv[:, cache_offset:cache_offset + s] = v.to(cv.dtype)
            kk = _repeat_kv(ck, reps).to(q.dtype)
            vv = _repeat_kv(cv, reps).to(q.dtype)
            cache_len = kk.shape[1]
            kpos = torch.arange(cache_len, device=x.device)[None, None,
                                                            None, :]
            qpos = cache_offset + torch.arange(s, device=x.device)[
                None, None, :, None]
            mask = kpos <= qpos
            if pad_lens is not None:
                mask = mask & ((kpos >= pad_lens[:, None, None, None])
                               | (kpos == qpos))
            out = xla_attention(q, kk, vv, mask=mask)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * hd))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype, bias=False)
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                   **f)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **f)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   **f)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.self_attn = LlamaAttention(cfg, **f)
        self.mlp = LlamaMLP(cfg, **f)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **f)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **f)

    def forward(self, x, positions, kv_cache=None, cache_offset: int = 0,
                attn_mask=None, pad_lens=None):
        x = x + self.self_attn(self.input_layernorm(x), positions, kv_cache,
                               cache_offset, attn_mask, pad_lens)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """Embedding table + decoder stack + final norm (HF `LlamaModel`).
    `forward` takes `inputs_embeds` and returns post-final-norm states."""

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        check_bf16_config(cfg)
        f = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.padded_vocab_size,
                                         cfg.hidden_size, **f)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, **f)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **f)

    def forward(self, inputs_embeds, positions,
                kv_caches: Optional[List[Dict]] = None,
                cache_offset: int = 0, attn_mask=None, pad_lens=None):
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            x = layer(x, positions,
                      kv_caches[i] if kv_caches is not None else None,
                      cache_offset, attn_mask, pad_lens)
        return self.norm(x)


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int, *,
                   dtype: torch.dtype, device) -> List[Dict]:
    """Empty per-layer (B, C, H_kv, D) bf16 (or fp32) cache buffers. The
    int8 cache of the JAX package is ROADMAP Queue 1 item 11."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise NotImplementedError(
            f"KV cache dtype {dtype}: only float caches are ported; the int8 "
            "cache is ROADMAP Queue 1 item 11")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]
