"""LLaMA decoder with an explicit KV cache: bf16 or int8 cache, float or
weight-quantized projections (W8A16 / W4A16, and with `act_quant` W8A8 /
W4A8), unfused or fused (`fused_qkv`).

Counterpart of `grove_tpu/models/llama.py` with the HF `LlamaModel` module
tree (`model.embed_tokens`, `model.layers.N.*`, `model.norm`):

* RoPE in HF's half-rotation convention, computed in fp32 exactly as
  `apply_rope` (`llama.py:74`) does;
* hidden states handed downstream are AFTER the final RMSNorm;
* the model consumes `inputs_embeds`; the video splice happens in
  `models.grove`;
* `_dense` picks `nn.Linear`, `Int4Linear` or `Int8Linear` by
  `weight_quant` / `weight_quant_bits` and hands them `act_quant`
  (`llama.py:43-61`); quantized weights come from `ops.quant.
  quantize_llama_`;
* `fused_qkv` (`models.fuse`): one `qkv_proj` and one `gate_up_proj`
  whose outputs are split, `llama.py:149-159`, `:321-327`;
* the W4A8 fused-norm carry (`llama.py:332-371`, `:401-440`): where the
  gate of `LlamaModel._fuse_ln` holds, every norm site runs K8c
  (`RMSNorm(quant_dyn=True)`) and hands its projections int8 activations
  with per-token scales, and each block returns its residual and its MLP
  branch un-added, for the next norm to add.

LoRA (`llama.py:98-112`, `:160-166`): with `lora_r > 0` every attention
has `q_proj_lora` and `v_proj_lora` (`LoraDelta`: `lora_A` (r, in), then
`lora_B` (out, r), scaled by alpha / r), added to q and v after the
projections and before RoPE; they stay in the float dtype when the
projections are quantized.

Remat (`llama.py:420-422`): `LlamaModel(remat=True)` runs each decoder
layer of the cache-free pass under `torch.utils.checkpoint`
(non-reentrant), the counterpart of `nn.remat`: its activations are
recomputed in the backward, so its forward, attention kernels included,
runs twice per training step.

Attention:
* no cache (teacher-forced and training pass), the JAX route
  (`llama.py:176-200`): K5 (`prefill_attention_
  trainable`) where `prefill_attention_ok` holds (as many kv heads as
  heads, S % 8 == 0, 128 <= S <= 1100) and `_block_for(S)` finds no block;
  otherwise `ops.attention.multi_head_attention`, i.e. K4 + K4b at an S
  that is a multiple of 64, K10 with its recompute backward at any other S
  >= 128 (the training driver's 2111 among them), the plain path below 128
  or with a mask. As in the port's first slice, the tensors' device takes
  the place of `default_backend() == "tpu"` (each kernel's wrapper runs its
  plain twin on the CPU) and the lane term `head_dim % 128 == 0` is dropped;
* the float cache (prefill, decode): plain fp32-softmax attention over the
  whole cache with a causal mask, and for left-padded prompts a mask that
  drops the pad slots but keeps each row's own slot (`llama.py:292-297`): a
  fully masked row would softmax to NaN and poison later layers through its
  k/v;
* the int8 cache (`llama.py:201-273`): prefill attends over the fresh k/v
  (K5 where `prefill_attention_ok` holds, else the masked plain path) while
  the quantized slabs are written; decode runs K6 over the int8 slabs.

A float cache is a list of {"k", "v"} (B, C, H_kv, D) tensors, one per
layer; an int8 cache a list of {"k", "v"} (B, H_kv, Cpad, D) int8 and
{"k_s", "v_s"} (B, H_kv, Cpad) bf16, the JAX layout. Both are written IN
PLACE at `cache_offset` (the JAX package returns updated copies).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import LlamaConfig
from ..ops.attention import (_block_for, multi_head_attention,
                             prefill_attention_ok, prefill_attention_raw,
                             prefill_attention_trainable, xla_attention)
from ..ops.decode_attention import NEG_INF, int8_cache_decode_attention
from . import layers
from .layers import Int4Linear, Int8Linear, RMSNorm, remat_call


def check_llama_config(cfg: LlamaConfig) -> None:
    """Raise for a LLaMA option value the port cannot build."""
    if cfg.weight_quant and cfg.weight_quant_bits not in (4, 8):
        raise ValueError(f"LlamaConfig.weight_quant_bits must be 4 or 8, "
                         f"got {cfg.weight_quant_bits}")


def _dense(cfg: LlamaConfig, in_features: int, out_features: int, *,
           bits: int = 0, device=None, dtype=None) -> nn.Module:
    """Linear factory (`llama.py:43-61`): `nn.Linear`, or with
    `weight_quant` an `Int4Linear` (`weight_quant_bits == 4`) or an
    `Int8Linear`, W4A8 / W8A8 with `act_quant`; callers pin `bits=8` for
    lm_head."""
    f = dict(device=device, dtype=dtype)
    if cfg.weight_quant:
        if (bits or cfg.weight_quant_bits) == 4:
            return Int4Linear(in_features, out_features, cfg.quant_group,
                              act_quant=cfg.act_quant, **f)
        return Int8Linear(in_features, out_features, act_quant=cfg.act_quant,
                          **f)
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


class LoraDelta(nn.Module):
    """Zero-init LoRA adapter (`llama.py:98-112`): x A^T B^T * (alpha / r),
    `lora_A` (r, in) and `lora_B` (out, r) bias-free linears."""

    def __init__(self, in_features: int, out_features: int, r: int,
                 alpha: float, *, device=None, dtype=None):
        super().__init__()
        f = dict(bias=False, device=device, dtype=dtype)
        self.scaling = alpha / r
        self.lora_A = nn.Linear(in_features, r, **f)
        self.lora_B = nn.Linear(r, out_features, **f)

    def forward(self, x):
        return self.lora_B(self.lora_A(x)) * self.scaling


def use_raw_prefill(cfg: LlamaConfig, s: int, heads: Optional[int] = None,
                    kv_heads: Optional[int] = None) -> bool:
    """`use_raw` of `llama.py:176-179`: K5 can take this layer's q/k/v at S
    tokens (the device test and the lane term are the port's, see the
    module docstring). `heads` / `kv_heads`: the heads this rank holds
    under tensor parallelism (the config's by default)."""
    heads = cfg.num_heads if heads is None else heads
    kv_heads = cfg.num_kv_heads if kv_heads is None else kv_heads
    return (kv_heads == heads
            and prefill_attention_ok((1, s, heads * cfg.head_dim), heads))


def _local_cols(t: torch.Tensor, width: int, tp) -> torch.Tensor:
    """This tensor-parallel rank's `width` columns of a replicated output
    (a LoRA delta beside a column-sharded projection); `tp` = (rank,
    size)."""
    if t.shape[-1] == width:
        return t
    return t.narrow(-1, tp[0] * width, width)


def _project(mod: nn.Module, x, sx):
    """A projection of x, or of the int8 carry (x, sx): only `Int4Linear`
    takes the carry (`llama.py:137-147`)."""
    if isinstance(mod, Int4Linear):
        return mod(x, sx)
    if sx is not None:
        raise ValueError("the fused-norm int8 carry reached a "
                         f"{type(mod).__name__}, which cannot take it")
    return mod(x)


class LlamaAttention(nn.Module):
    """Under tensor parallelism (`parallel.sharding.shard_pytree`) q/k/v
    are column-sharded and o row-sharded: this rank's projections hand it
    `num_heads / tp` heads as plain local tensors, and the head counts
    below are read from their widths, so the attention kernels never see a
    DTensor. `tp` = (rank, size) on the "model" axis; the LoRA deltas stay
    replicated (no JAX rule matches them) and give this rank its
    columns."""

    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        f = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.tp = (0, 1)
        d, hd = cfg.hidden_size, cfg.head_dim
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        if cfg.fused_qkv:
            self.qkv_proj = _dense(cfg, d, nq + 2 * nkv, **f)
        else:
            self.q_proj = _dense(cfg, d, nq, **f)
            self.k_proj = _dense(cfg, d, nkv, **f)
            self.v_proj = _dense(cfg, d, nkv, **f)
        self.o_proj = _dense(cfg, nq, d, **f)
        if cfg.lora_r > 0:
            # the reference's LoRA targets q_proj and v_proj (`train.py:52`)
            self.q_proj_lora = LoraDelta(d, nq, cfg.lora_r, cfg.lora_alpha,
                                         **f)
            self.v_proj_lora = LoraDelta(d, nkv, cfg.lora_r, cfg.lora_alpha,
                                         **f)

    def forward(self, x, positions, kv_cache: Optional[Dict] = None,
                cache_offset: int = 0, attn_mask=None, pad_lens=None,
                sx=None):
        """`sx` given: x arrived per-token int8 from the fused-norm carry
        (x ~= x_int8 * sx)."""
        cfg = self.cfg
        hd = cfg.head_dim
        if cfg.fused_qkv:
            # no JAX rule shards the fused projection: all heads, here too
            nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
            # contiguous thirds: the attention kernels take no strides
            q, k, v = (t.contiguous() for t in torch.split(
                _project(self.qkv_proj, x, sx), (nq, nkv, nkv), dim=-1))
        else:
            q, k, v = (_project(m, x, sx)
                       for m in (self.q_proj, self.k_proj, self.v_proj))
        if cfg.lora_r > 0:
            if sx is not None:
                raise ValueError("the fused-norm int8 carry reached a LoRA "
                                 "attention, which reads float activations")
            q = q + _local_cols(self.q_proj_lora(x), q.shape[-1], self.tp)
            v = v + _local_cols(self.v_proj_lora(x), v.shape[-1], self.tp)
        b, s = q.shape[:2]
        nh, nkh = q.shape[-1] // hd, k.shape[-1] // hd
        reps = nh // nkh
        q = q.reshape(b, s, nh, hd)
        k = k.reshape(b, s, nkh, hd)
        v = v.reshape(b, s, nkh, hd)
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if kv_cache is None:
            # pure self-attention (teacher-forced inference, training)
            if (use_raw_prefill(cfg, s, nh, nkh) and attn_mask is None
                    and _block_for(s) is None):
                out = prefill_attention_trainable(
                    q.reshape(b, s, -1), k.reshape(b, s, -1),
                    v.reshape(b, s, -1), nh,
                    1.0 / hd ** 0.5).reshape(b, s, nh, hd)
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
        return self.o_proj(out.reshape(b, s, nh * hd))

    def _int8_cache_attention(self, q, k, v, cache, offset: int, pad_lens):
        """`llama.py:201-273`: write the quantized k/v slabs at `offset`;
        prefill (s > 1) attends over the fresh-precision k/v (GROVE prefill
        starts from an empty cache), decode (s == 1) runs K6 over the int8
        cache."""
        cfg = self.cfg
        b, s, hq, hd = q.shape
        reps = hq // k.shape[2]
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
        if use_raw_prefill(cfg, s, hq, k.shape[2]):
            pad_eff = (pad_lens - offset if pad_lens is not None
                       else torch.zeros((b,), dtype=torch.long,
                                        device=q.device))
            return prefill_attention_raw(
                q.reshape(b, s, -1), k.to(q.dtype).reshape(b, s, -1),
                v.to(q.dtype).reshape(b, s, -1), pad_eff, hq,
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
        self.cfg = cfg
        d, i = cfg.hidden_size, cfg.intermediate_size
        if cfg.fused_qkv:
            self.gate_up_proj = _dense(cfg, d, 2 * i, **f)
        else:
            self.gate_proj = _dense(cfg, d, i, **f)
            self.up_proj = _dense(cfg, d, i, **f)
        self.down_proj = _dense(cfg, i, d, **f)

    def forward(self, x, sx=None):
        if self.cfg.fused_qkv:
            gu = _project(self.gate_up_proj, x, sx)
            i = self.cfg.intermediate_size
            gate, up = gu[..., :i], gu[..., i:]
        else:
            gate = _project(self.gate_proj, x, sx)
            up = _project(self.up_proj, x, sx)
        return self.down_proj(F.silu(gate) * up)


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

    def forward_seq_parallel(self, x, positions, mesh):
        """The cache-free block under sequence parallelism: x is this
        rank's (B, S / tp, D) slice of the residual stream, normalized
        here (the norms' weight gradients summed over the "model" ranks);
        the projections take the whole sequence, gathered, and their
        replicated output is sliced back (`parallel.mesh.seq_gather` /
        `seq_slice`)."""
        from ..parallel.mesh import seq_gather, seq_slice, seq_rms_norm
        h = seq_gather(seq_rms_norm(self.input_layernorm, x, mesh), mesh)
        x = x + seq_slice(self.self_attn(h, positions), mesh)
        h = seq_gather(seq_rms_norm(self.post_attention_layernorm, x, mesh),
                       mesh)
        return x + seq_slice(self.mlp(h), mesh)

    def forward_fused_ln(self, x, branch, positions, kv_cache=None,
                         cache_offset: int = 0, attn_mask=None,
                         pad_lens=None):
        """The W4A8 fused-norm block (`llama.py:349-361`): both norms run
        K8c and hand their projections (q8, sx); x + branch, the previous
        block's un-added residual carry, is added by the first norm.
        Returns the carry (resid, mlp branch)."""
        resid, q8, sx = self.input_layernorm(x, branch, quant_dyn=True)
        attn_out = self.self_attn(q8, positions, kv_cache, cache_offset,
                                  attn_mask, pad_lens, sx=sx)
        resid, q8, sx = self.post_attention_layernorm(resid, attn_out,
                                                      quant_dyn=True)
        return resid, self.mlp(q8, sx)


class LlamaModel(nn.Module):
    """Embedding table + decoder stack + final norm (HF `LlamaModel`).
    `forward` takes `inputs_embeds` and returns post-final-norm states.
    `llama_cfg` is the config its modules were built for; the in-place
    transforms of `ops.quant` and `models.fuse` update it through
    `set_llama_cfg_`. With `remat`, the cache-free pass checkpoints each
    decoder layer when gradients are on (`llama.py:420-422`).

    `act_sharding` (`llama.py:377-396`): None, or the "model" mesh of a
    tensor-parallel model (`parallel.sharding.shard_pytree` sets it from
    `GroveModel(llm_act_sharding=)`): the cache-free pass then keeps the
    residual stream between blocks sharded on S over that mesh (sequence
    parallelism) where S divides by its size; elsewhere the stream stays
    whole on every rank, the same numbers (a placement, no parameter).

    `stages`: None, or the device of each decoder layer, which
    `parallel.pipeline.place_stages` sets where it spreads the layers over
    pipeline stages."""

    def __init__(self, cfg: LlamaConfig, *, remat: bool = False, device=None,
                 dtype=None):
        super().__init__()
        check_llama_config(cfg)
        f = dict(device=device, dtype=dtype)
        self.llama_cfg = cfg
        self.remat = remat
        self.act_sharding = None
        self.stages = None
        self.embed_tokens = nn.Embedding(cfg.padded_vocab_size,
                                         cfg.hidden_size, **f)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, **f)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **f)

    def _fuse_ln(self, x, cache_free: bool) -> bool:
        """The gate of the fused-norm carry (`llama.py:408-419`): W4A8
        weights on the card, no LoRA, a multi-token shape of 64 tokens or
        more, every width the int8-view path takes, and no remat of a
        cache-free pass, and no sequence parallelism."""
        cfg = self.llama_cfg
        b, s = x.shape[:2]
        hd = cfg.head_dim
        return (layers._on_card(x) and cfg.weight_quant
                and cfg.weight_quant_bits == 4 and cfg.act_quant
                and cfg.lora_r == 0 and s > 1 and b * s >= 64
                and cfg.hidden_size % 128 == 0
                and cfg.quant_group % 128 == 0
                and cfg.intermediate_size % 128 == 0
                and (cfg.num_heads * hd) % 128 == 0
                and (cfg.num_kv_heads * hd) % 128 == 0
                and self.act_sharding is None
                and not (self.remat and cache_free))

    def forward(self, inputs_embeds, positions,
                kv_caches: Optional[List[Dict]] = None,
                cache_offset: int = 0, attn_mask=None, pad_lens=None):
        x = inputs_embeds
        cache_free = kv_caches is None
        mesh = self.act_sharding
        if (mesh is not None and cache_free and attn_mask is None
                and x.shape[1] % mesh.size() == 0):
            return self._forward_seq_parallel(x, positions, mesh)
        if self.stages is not None:
            return self._forward_stages(x, positions, kv_caches,
                                        cache_offset, attn_mask, pad_lens)
        fuse_ln = self._fuse_ln(x, cache_free)
        branch = None
        for i, layer in enumerate(self.layers):
            args = (positions, None if cache_free else kv_caches[i],
                    cache_offset, attn_mask, pad_lens)
            if fuse_ln:
                x, branch = layer.forward_fused_ln(x, branch, *args)
            else:
                x = remat_call(self.remat and cache_free, layer, x, *args)
        return self.norm(x, branch)

    def _forward_stages(self, x, positions, kv_caches, cache_offset,
                        attn_mask, pad_lens):
        """`forward` with each layer on the device `stages` names: the
        layer's inputs follow it there, and its card is the current one
        while it launches kernels (a kernel runs on the current card); the
        final norm runs on its own device. The KV caches are not moved:
        a cached pass needs every stage on one device."""
        cache_free = kv_caches is None
        fuse_ln = self._fuse_ln(x, cache_free)
        branch = None
        for i, (layer, dev) in enumerate(zip(self.layers, self.stages)):
            x, branch, positions, attn_mask, pad_lens = _to_device(
                dev, x, branch, positions, attn_mask, pad_lens)
            args = (positions, None if cache_free else kv_caches[i],
                    cache_offset, attn_mask, pad_lens)
            with _current_card(dev):
                if fuse_ln:
                    x, branch = layer.forward_fused_ln(x, branch, *args)
                else:
                    x = remat_call(self.remat and cache_free, layer, x,
                                   *args)
        x, branch = _to_device(self.norm.weight.device, x, branch)
        return self.norm(x, branch)

    def _forward_seq_parallel(self, x, positions, mesh):
        from ..parallel.mesh import seq_gather, seq_rms_norm, seq_slice
        x = seq_slice(x, mesh)
        for layer in self.layers:
            x = remat_call(self.remat, layer.forward_seq_parallel, x,
                           positions, mesh)
        return seq_gather(seq_rms_norm(self.norm, x, mesh), mesh)

    def init_kv_caches(self, batch: int, max_len: int, *,
                       dtype: torch.dtype, device) -> List[Dict]:
        """`init_kv_caches` for this model: under tensor parallelism each
        rank caches the KV heads its k/v projections hand it."""
        attn = self.layers[0].self_attn
        kv_heads = self.llama_cfg.num_kv_heads
        if not self.llama_cfg.fused_qkv:
            kv_heads //= attn.tp[1]
        return init_kv_caches(self.llama_cfg, batch, max_len, dtype=dtype,
                              device=device, kv_heads=kv_heads)


def _to_device(dev, *tensors):
    """`tensors` on `dev` (None stays None)."""
    return tuple(t if t is None else t.to(dev) for t in tensors)


def _current_card(dev):
    """`dev` as the current card where it is another card."""
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def set_llama_cfg_(model: LlamaModel, cfg: LlamaConfig) -> None:
    """Point a decoder stack and its attention and MLP modules at `cfg`,
    after an in-place transform changed the flags they read
    (`act_quant`, `fused_qkv`, the quantization fields)."""
    model.llama_cfg = cfg
    for layer in model.layers:
        layer.self_attn.cfg = layer.mlp.cfg = cfg


def init_kv_caches(cfg: LlamaConfig, batch: int, max_len: int, *,
                   dtype: torch.dtype, device,
                   kv_heads: Optional[int] = None) -> List[Dict]:
    """Empty per-layer cache buffers (`llama.py:469-497`): (B, C, H_kv, D)
    k/v of a float dtype, or with `dtype=torch.int8` the JAX package's
    quantized layout, (B, H_kv, Cpad, D) int8 k/v and (B, H_kv, Cpad) bf16
    scales, Cpad = max_len rounded up to a multiple of 128 (the pad slots
    are masked by the decode bias). `kv_heads`: the heads cached, the
    config's by default (`LlamaModel.init_kv_caches` gives a
    tensor-parallel rank's)."""
    heads = cfg.num_kv_heads if kv_heads is None else kv_heads
    if dtype == torch.int8:
        cpad = -(-max_len // 128) * 128
        kshape = (batch, heads, cpad, cfg.head_dim)
        sshape = (batch, heads, cpad)
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
    shape = (batch, max_len, heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]
