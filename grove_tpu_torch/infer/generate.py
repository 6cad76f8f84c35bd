"""Greedy KV-cache generation and grounded-caption assembly.

Counterpart of `grove_tpu/infer/generate.py` (reference `evaluate()`,
`model/GROVE.py:412-451`): prefill, then a Python greedy loop over the KV
cache (bf16 by default, `cache_dtype=torch.int8` for the quantized one) that
keeps every step's post-norm hidden state in a (B, max_new, D)
buffer for the [DET] gather, and freezes each sequence after its EOS,
exactly as `_decode_fn` (`generate.py:60-139`). With `early_exit` the loop
stops once every sequence is done; emitted ids are the same either way.

Temperature / top-k / top-p sampling and beam search raise for now
(ROADMAP Queue 1 items 8 and 12).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from grove_tpu.config import GroveConfig
from grove_tpu.text import tagging
from grove_tpu.text.packing import det_gather_positions

from ..models.grove import GroveModel
from ..models.llama import init_kv_caches


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
                  top_k: int = 0, top_p: float = 1.0):
    """Greedy generation. spliced_ids (B, Ls); unequal prompts arrive
    LEFT-padded with `pad_lens` (B,).

    Returns (generated_ids (B, max_new) long, hidden (B, Ls+max_new, D));
    hidden-state slots past an early stop stay zero, and the [DET] gather
    never reads them (det positions lie inside the caption)."""
    if temperature > 0.0 or top_k > 0 or top_p < 1.0:
        raise NotImplementedError(
            "sampled decoding (temperature/top-k/top-p) is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    dev = model.device
    ids = _as_device(spliced_ids, dev, torch.long)
    pad_lens = _as_device(pad_lens, dev, torch.long)
    b, ls = ids.shape
    d = model.cfg.llama.hidden_size
    caches = init_kv_caches(model.cfg.llama, b, ls + max_new_tokens,
                            dtype=cache_dtype or model.dtype, device=dev)
    prefill_hidden, logits, caches = model.prefill(
        ids, video_embeds, video_start, caches, pad_lens)
    tok = torch.argmax(logits[:, -1, :], dim=-1)

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
        next_tok = torch.argmax(logits[:, -1, :], dim=-1)
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
    """Grounded caption generation: encoders -> greedy decode -> host
    [DET]-position extraction -> grounding head. Returns numpy arrays plus
    the parsed text fields, with the JAX function's keys. `length_penalty`
    applies to beam search only."""
    if num_beams > 1:
        raise NotImplementedError("beam search is not ported yet (ROADMAP "
                                  "Queue 1 item 12)")
    dev = model.device
    frames_clip = _as_device(frames_clip, dev)
    frames_sam = _as_device(frames_sam, dev)
    video_embeds, _ = model.encode_video(frames_clip)
    image_embeddings = model.encode_grounding_auto(frames_sam, sam_valid_hw)
    gen_ids, hidden = greedy_decode(
        model, spliced_ids, video_embeds, video_start,
        max_new_tokens=max_new_tokens, eos_id=cfg.tokens.eos,
        pad_id=cfg.tokens.pad, cache_dtype=cache_dtype, pad_lens=pad_lens,
        early_exit=early_exit, **sampling)

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
