"""LLaMA decoder with an explicit KV cache: bf16 or int8 cache, float or
weight-quantized (W8A16 / W4A16) projections.

Counterpart of `grove_tpu/models/llama.py` with the HF `LlamaModel` module
tree (`model.embed_tokens`, `model.layers.N.*`, `model.norm`):

* RoPE in HF's half-rotation convention, computed in fp32 exactly as
  `apply_rope` (`llama.py:74`) does;
* hidden states handed downstream are AFTER the final RMSNorm;
* the model consumes `inputs_embeds`; the video splice happens in
  `models.grove`;
* `_dense` picks `nn.Linear`, `Int4Linear` or `Int8Linear` by
  `weight_quant` / `weight_quant_bits` (`llama.py:43-61`); quantized
  weights come from `ops.quant.quantize_llama_`.

Attention:
* no cache (teacher-forced pass): causal self-attention through
  `ops.attention.multi_head_attention`, i.e. K4 on the card; at an S that
  is not a multiple of 64, with as many kv heads as heads, K5
  (`prefill_attention_trainable`), as `llama.py:187-197`;
* the float cache (prefill, decode): plain fp32-softmax attention over the
  whole cache with a causal mask, and for left-padded prompts a mask that
  drops the pad slots but keeps each row's own slot (`llama.py:292-297`): a
  fully masked row would softmax to NaN and poison later layers through its
  k/v;
* the int8 cache (`llama.py:201-273`): prefill attends over the fresh k/v
  (K5 with as many kv heads as heads, else the masked plain path) while the
  quantized slabs are written; decode runs K6 over the int8 slabs.

A float cache is a list of {"k", "v"} (B, C, H_kv, D) tensors, one per
layer; an int8 cache a list of {"k", "v"} (B, H_kv, Cpad, D) int8 and
{"k_s", "v_s"} (B, H_kv, Cpad) bf16, the JAX layout. Both are written IN
PLACE at `cache_offset` (the JAX package returns updated copies).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from grove_tpu.config import LlamaConfig

from ..ops.attention import (multi_head_attention, prefill_attention_raw,
                             prefill_attention_trainable, xla_attention)
from ..ops.decode_attention import NEG_INF, int8_cache_decode_attention
from .layers import Int4Linear, Int8Linear, RMSNorm


def check_llama_config(cfg: LlamaConfig) -> None:
    """Raise for the LLaMA options the port does not run yet."""
    if cfg.act_quant:
        raise NotImplementedError(
            "LlamaConfig.act_quant: W4A8 / W8A8 LLM activations are not "
            "ported yet (ROADMAP Queue 1 item 11b)")
    if cfg.fused_qkv:
        raise NotImplementedError(
            "LlamaConfig.fused_qkv: fused projections are not ported yet "
            "(ROADMAP Queue 1 item 11b)")
    if cfg.lora_r > 0:
        raise NotImplementedError(
            "LlamaConfig.lora_r > 0: LoRA belongs to the training slice "
            "(ROADMAP Queue 1 item 14)")
    if cfg.weight_quant and cfg.weight_quant_bits not in (4, 8):
        raise ValueError(f"LlamaConfig.weight_quant_bits must be 4 or 8, "
                         f"got {cfg.weight_quant_bits}")


def _dense(cfg: LlamaConfig, in_features: int, out_features: int, *,
           bits: int = 0, device=None, dtype=None) -> nn.Module:
    """Linear factory (`llama.py:43-61`): `nn.Linear`, or with
    `weight_quant` an `Int4Linear` (`weight_quant_bits == 4`) or an
    `Int8Linear`; callers pin `bits=8` for lm_head."""
    f = dict(device=device, dtype=dtype)
    if cfg.weight_quant:
        if (bits or cfg.weight_quant_bits) == 4:
            return Int4Linear(in_features, out_features, cfg.quant_group,
                              **f)
        return Int8Linear(in_features, out_features, **f)
    return nn.Linear(in_features, out_features, bias=False, **f)


def quantize_kv(x: torch.Tensor):
    """Per-token, per-head absmax int8 quantization of a (B, S, H, D) K or V
    slab (`llama.py:88-95`): the fp32 scale rounds the values, and is then
    stored as bf16. Returns (int8 values, (B, S, H, 1) bf16 scales)."""
    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


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
        f = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.q_proj = _dense(cfg, d, nq, **f)
        self.k_proj = _dense(cfg, d, nkv, **f)
        self.v_proj = _dense(cfg, d, nkv, **f)
        self.o_proj = _dense(cfg, nq, d, **f)

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
            if attn_mask is None and reps == 1 and s % 64:
                out = prefill_attention_trainable(
                    q.reshape(b, s, -1), k.reshape(b, s, -1),
                    v.reshape(b, s, -1), cfg.num_heads,
                    1.0 / hd ** 0.5).reshape(b, s, cfg.num_heads, hd)
            else:
                out = multi_head_attention(q, _repeat_kv(k, reps),
                                           _repeat_kv(v, reps), causal=True,
                                           mask=attn_mask)
        elif "k_s" in kv_cache:
            out = self._int8_cache_attention(q, k, v, kv_cache, cache_offset,
                                             pad_lens)
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

    def _int8_cache_attention(self, q, k, v, cache, offset: int, pad_lens):
        """`llama.py:201-273`: write the quantized k/v slabs at `offset`;
        prefill (s > 1) attends over the fresh-precision k/v (GROVE prefill
        starts from an empty cache), decode (s == 1) runs K6 over the int8
        cache."""
        cfg = self.cfg
        b, s, hq, hd = q.shape
        reps = cfg.num_heads // cfg.num_kv_heads
        for name, x in (("k", k), ("v", v)):
            xq, xs = quantize_kv(x)
            cache[name][:, :, offset:offset + s] = xq.transpose(1, 2)
            cache[name + "_s"][:, :, offset:offset + s] = \
                xs[..., 0].transpose(1, 2)
        if s == 1:
            cpad = cache["k"].shape[2]
            kpos = torch.arange(cpad, device=q.device)[None, :]
            valid = kpos <= offset
            if pad_lens is not None:
                valid = valid & ((kpos >= pad_lens[:, None])
                                 | (kpos == offset))
            bias = torch.where(valid.expand(b, cpad), 0.0, NEG_INF)
            out = int8_cache_decode_attention(
                q[:, 0].contiguous(), cache["k"], cache["v"], cache["k_s"],
                cache["v_s"], bias)
            return out[:, None]
        if reps == 1:
            pad_eff = (pad_lens - offset if pad_lens is not None
                       else torch.zeros((b,), dtype=torch.long,
                                        device=q.device))
            return prefill_attention_raw(
                q.reshape(b, s, -1), k.to(q.dtype).reshape(b, s, -1),
                v.to(q.dtype).reshape(b, s, -1), pad_eff, cfg.num_heads,
                1.0 / hd ** 0.5).reshape(b, s, hq, hd)
        kidx = torch.arange(s, device=q.device)[None, None, None, :]
        qidx = torch.arange(s, device=q.device)[None, None, :, None]
        mask = kidx <= qidx
        if pad_lens is not None:
            mask = mask & ((offset + kidx >= pad_lens[:, None, None, None])
                           | (kidx == qidx))
        return xla_attention(q, _repeat_kv(k, reps).to(q.dtype),
                             _repeat_kv(v, reps).to(q.dtype), mask=mask)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _dense(cfg, d, i, **f)
        self.up_proj = _dense(cfg, d, i, **f)
        self.down_proj = _dense(cfg, i, d, **f)

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
        check_llama_config(cfg)
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
    """Empty per-layer cache buffers (`llama.py:469-497`): (B, C, H_kv, D)
    k/v of a float dtype, or with `dtype=torch.int8` the JAX package's
    quantized layout, (B, H_kv, Cpad, D) int8 k/v and (B, H_kv, Cpad) bf16
    scales, Cpad = max_len rounded up to a multiple of 128 (the pad slots
    are masked by the decode bias)."""
    if dtype == torch.int8:
        cpad = -(-max_len // 128) * 128
        kshape = (batch, cfg.num_kv_heads, cpad, cfg.head_dim)
        sshape = (batch, cfg.num_kv_heads, cpad)
        return [{"k": torch.zeros(kshape, dtype=torch.int8, device=device),
                 "v": torch.zeros(kshape, dtype=torch.int8, device=device),
                 "k_s": torch.zeros(sshape, dtype=torch.bfloat16,
                                    device=device),
                 "v_s": torch.zeros(sshape, dtype=torch.bfloat16,
                                    device=device)}
                for _ in range(cfg.num_layers)]
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"KV cache dtype {dtype}: expected a float dtype or "
                         "torch.int8")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]
