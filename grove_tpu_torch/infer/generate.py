"""KV-cache generation and grounded-caption assembly.

Counterpart of `grove_tpu/infer/generate.py` (reference `evaluate()`,
`model/GROVE.py:412-451`): prefill, then a Python decode loop over the KV
cache (bf16 when `cache_dtype` is None, whatever the model's dtype, as the
JAX defaults `cache_dtype=jnp.bfloat16` (`generate.py:144,204`);
`cache_dtype=torch.int8` for the quantized one) that
keeps every step's post-norm hidden state in a (B, max_new, D)
buffer for the [DET] gather, and freezes each sequence after its EOS,
exactly as `_decode_fn` (`generate.py:60-139`). With `early_exit` the loop
stops once every sequence is done; emitted ids are the same either way.

Decoding is greedy at temperature 0. Above it, each step samples as
`_make_sampler` (`generate.py:29-57`) does, split in two: `filter_logits`
(temperature in fp32, top-k, nucleus top-p) and a Gumbel-max draw,
`argmax(filtered + g)`, which is how `jax.random.categorical` draws. The
noise `g` comes from a `torch.Generator` on the model's device, seeded with
0 when the caller gives none (the JAX package's `PRNGKey(0)`).
`num_beams > 1` in `generate_grounded` runs `infer.beam.beam_decode`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..config import GroveConfig
from ..text import tagging
from ..text.packing import det_gather_positions
from ..models.grove import GroveModel


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """The sampler's support (`generate.py:40-54`): fp32 logits divided by
    `temperature`; with `top_k`, every logit below the k-th largest set to
    -inf (ties with the k-th kept); with `top_p` < 1, the nucleus over the
    descending sort, `(cum - probs) < top_p` with the top token always kept,
    thresholded at the smallest kept logit. Returns (..., V) fp32."""
    t = torch.full((), float(temperature), dtype=torch.float32,
                   device=logits.device)
    # a true division by a device tensor: a Python scalar divisor becomes a
    # multiplication by its reciprocal on the card
    l = logits.float() / t
    if top_k > 0:
        kth = torch.topk(l, min(int(top_k), l.shape[-1]), dim=-1).values
        l = torch.where(l < kth[..., -1:], float("-inf"), l)
    if top_p < 1.0:
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        thresh = torch.where(keep, sorted_l, float("inf")).amin(
            -1, keepdim=True)
        l = torch.where(l >= thresh, l, float("-inf"))
    return l


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, fp32: -log(-log(u)) with u uniform on
    [tiny, 1), so that every value is finite (`jax.random.gumbel`)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def next_tokens(logits: torch.Tensor, step: int, temperature: float,
                top_k: int, top_p: float, generator=None,
                _noise=None) -> torch.Tensor:
    """One pick for every row of (B, V) logits: argmax at temperature 0,
    else `argmax(filter_logits(...) + g)`. `g` is drawn from `generator`;
    `_noise(step)`, where a test sets it, hands the (B, V) noise of the
    step instead (the JAX package's
    `gumbel(fold_in(key, step), (B, V), float32)`)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    l = filter_logits(logits, temperature, top_k, top_p)
    if _noise is not None:
        g = torch.tensor(np.asarray(_noise(step)), dtype=torch.float32,
                         device=l.device)
    else:
        g = gumbel_noise(l.shape, generator, l.device)
    return torch.argmax(l + g, dim=-1)


def _as_device(x, device, dtype=None):
    if x is None:
        return None
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    return t.to(device=device, dtype=dtype)


@torch.inference_mode()
def greedy_decode(model: GroveModel, spliced_ids, video_embeds, video_start,
                  *, max_new_tokens: int, eos_id: int, pad_id: int = 0,
                  cache_dtype: Optional[torch.dtype] = None, pad_lens=None,
                  early_exit: bool = True, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None, _noise=None):
    """Autoregressive generation. spliced_ids (B, Ls); unequal prompts
    arrive LEFT-padded with `pad_lens` (B,).

    Greedy by default; `temperature > 0` samples with optional `top_k` /
    nucleus `top_p` truncation (`next_tokens`), drawing from `generator`
    (a `torch.Generator` on the model's device; seed 0 when None).

    Returns (generated_ids (B, max_new) long, hidden (B, Ls+max_new, D));
    hidden-state slots past an early stop stay zero, and the [DET] gather
    never reads them (det positions lie inside the caption)."""
    dev = model.device
    if temperature > 0.0 and generator is None and _noise is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    pick = functools.partial(next_tokens, temperature=temperature,
                             top_k=top_k, top_p=top_p, generator=generator,
                             _noise=_noise)
    ids = _as_device(spliced_ids, dev, torch.long)
    pad_lens = _as_device(pad_lens, dev, torch.long)
    b, ls = ids.shape
    d = model.cfg.llama.hidden_size
    caches = model.model.init_kv_caches(
        b, ls + max_new_tokens, dtype=cache_dtype or torch.bfloat16,
        device=dev)
    prefill_hidden, logits, caches = model.prefill(
        ids, video_embeds, video_start, caches, pad_lens)
    tok = pick(logits[:, -1, :], 0)

    gen = torch.full((b, max_new_tokens), pad_id, dtype=torch.long,
                     device=dev)
    step_hidden = torch.zeros((b, max_new_tokens, d),
                              dtype=prefill_hidden.dtype, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        if early_exit and bool(done.all()):
            break
        hidden, logits, caches = model.decode_step(tok[:, None], ls + i,
                                                   caches, pad_lens)
        next_tok = pick(logits[:, -1, :], i + 1)
        gen[:, i] = torch.where(done, pad_id, tok)
        done = done | (tok == eos_id)
        step_hidden[:, i] = hidden[:, 0]
        tok = torch.where(done, pad_id, next_tok)
    return gen, torch.cat([prefill_hidden, step_hidden], dim=1)


def left_pad_prompts(prompts, video_starts, pad_id: int = 0,
                     pad_to_multiple: Optional[int] = None):
    """Ragged spliced prompts -> (ids (B, Lmax), video_start, pad_lens),
    numpy, as `grove_tpu/infer/generate.py:left_pad_prompts`."""
    lens = [len(p) for p in prompts]
    lmax = max(lens)
    if pad_to_multiple:
        lmax = -(-lmax // pad_to_multiple) * pad_to_multiple
    b = len(prompts)
    ids = np.full((b, lmax), pad_id, np.int64)
    pad_lens = np.zeros((b,), np.int64)
    starts = np.asarray(video_starts, np.int64).copy()
    for i, p in enumerate(prompts):
        pad = lmax - lens[i]
        ids[i, pad:] = np.asarray(p, np.int64)
        pad_lens[i] = pad
        if starts[i] >= 0:
            starts[i] += pad
    return ids, starts, pad_lens


@torch.inference_mode()
def generate_grounded(model: GroveModel, cfg: GroveConfig, tokenizer,
                      spliced_ids, video_start, frames_clip, frames_sam, *,
                      max_new_tokens: int = 64, pad_lens=None,
                      cache_dtype: Optional[torch.dtype] = None,
                      early_exit: bool = True, num_beams: int = 1,
                      length_penalty: float = 1.0, sam_valid_hw=None,
                      **sampling) -> Dict:
    """Grounded caption generation: encoders -> decode (`greedy_decode`,
    or `beam_decode` with `num_beams > 1`, as `generate.py:222-230`) ->
    host [DET]-position extraction -> grounding head. Returns numpy arrays
    plus the parsed text fields, with the JAX function's keys.
    `length_penalty` applies to beam search only; `sampling` holds
    `greedy_decode`'s temperature, top_k, top_p and generator."""
    dev = model.device
    frames_clip = _as_device(frames_clip, dev)
    frames_sam = _as_device(frames_sam, dev)
    video_embeds, _ = model.encode_video(frames_clip)
    image_embeddings = model.encode_grounding_auto(frames_sam, sam_valid_hw)
    if num_beams > 1:
        from .beam import beam_decode
        gen_ids, hidden, _ = beam_decode(
            model, spliced_ids, video_embeds, video_start,
            max_new_tokens=max_new_tokens, eos_id=cfg.tokens.eos,
            pad_id=cfg.tokens.pad, num_beams=num_beams,
            length_penalty=length_penalty, cache_dtype=cache_dtype,
            pad_lens=pad_lens, early_exit=early_exit)
    else:
        gen_ids, hidden = greedy_decode(
            model, spliced_ids, video_embeds, video_start,
            max_new_tokens=max_new_tokens, eos_id=cfg.tokens.eos,
            pad_id=cfg.tokens.pad, cache_dtype=cache_dtype,
            pad_lens=pad_lens, early_exit=early_exit, **sampling)

    gen_np = gen_ids.cpu().numpy()
    ids_np = (spliced_ids.cpu().numpy() if isinstance(spliced_ids,
                                                      torch.Tensor)
              else np.asarray(spliced_ids))
    full_ids = np.concatenate([ids_np, gen_np], axis=1)
    b = full_ids.shape[0]
    det_positions = np.zeros((b, cfg.max_phrases), np.int64)
    phrase_mask = np.zeros((b, cfg.max_phrases), bool)
    for i in range(b):
        det_positions[i], phrase_mask[i] = det_gather_positions(
            full_ids[i], cfg.tokens.det, cfg.max_phrases)

    boxes, obj = model.ground(hidden, _as_device(det_positions, dev),
                              image_embeddings)
    parsed = []
    for i in range(b):
        toks = [int(t) for t in gen_np[i] if t != cfg.tokens.pad]
        parsed.append(tagging.parse_generation(
            tokenizer.decode(toks, skip_special_tokens=False)))
    return {
        "generated_ids": gen_np,
        "pred_boxes": boxes.float().cpu().numpy(),
        "objectness_logits": (obj.float().cpu().numpy()
                              if obj is not None else None),
        "det_positions": det_positions,
        "phrase_mask": phrase_mask,
        "parsed": parsed,
    }
