"""Beam-search decoding for grounded caption generation.

Counterpart of `grove_tpu/infer/beam.py`: prefill once per clip, then K
beams per clip on B·K cache rows. After every step the candidates
(score + log-prob over the vocabulary) of a clip's K beams are re-ranked,
and the KV cache, the hidden-state buffer, the tokens and `done` are
reordered by the winners' rows, as HF's beam scorer does. A beam that
emitted EOS is frozen: its only continuation is pad at no cost (the other
tokens get NEG_INF). The last step skips the re-rank (`beam.py:100-111`):
its pick would never be recorded. The final choice maximizes
score / length**length_penalty, HF's normalization, and the winning beam's
per-step hidden states are returned for the [DET] gather.

The port writes a float cache in place (`models.llama`), so the reorder
never gathers a buffer into itself: each cache tensor and the hidden buffer
have a second buffer, the gather writes there, and the two swap. Ties in a
re-rank go to the lower flat index, as `lax.top_k` gives them.

An int8 cache is rejected, as in the JAX package (its transposed layout
would make the per-step reorder a gather along the cache width there).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.grove import GroveModel
from .generate import _as_device

NEG_INF = -1.0e9


def _top_k(x: torch.Tensor, k: int):
    """The k largest of the last axis, descending, ties to the lower
    index (`lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_decode(model: GroveModel, spliced_ids, video_embeds, video_start,
                *, max_new_tokens: int, eos_id: int, num_beams: int = 4,
                pad_id: int = 0, length_penalty: float = 1.0,
                cache_dtype: Optional[torch.dtype] = None, pad_lens=None,
                early_exit: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam-search generation with per-step hidden capture.

    `early_exit` stops once every beam of every clip has recorded its EOS
    (identical results). Returns (best_ids (B, max_new), hidden (B,
    Ls+max_new, D), beam scores (B, K) length-normalized). With
    num_beams=1 the ids equal `greedy_decode`'s. The cache is bf16 when
    `cache_dtype` is None, as the JAX default (`beam.py:164`)."""
    cache_dtype = cache_dtype or torch.bfloat16
    if cache_dtype == torch.int8:
        raise ValueError("beam search needs a reorderable KV cache; "
                         "use bf16/fp32 (int8's transposed layout would "
                         "make the per-step beam reorder a lane gather)")
    dev = model.device
    ids = _as_device(spliced_ids, dev, torch.long)
    pad_lens = _as_device(pad_lens, dev, torch.long)
    b, ls = ids.shape
    k = int(num_beams)
    r = b * k
    d = model.cfg.llama.hidden_size

    caches = model.model.init_kv_caches(b, ls + max_new_tokens,
                                        dtype=cache_dtype, device=dev)
    prefill_hidden, logits, caches = model.prefill(
        ids, video_embeds, video_start, caches, pad_lens)
    logprobs0 = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
    v = logprobs0.shape[-1]
    scores, cur = _top_k(logprobs0, k)                   # (B, K)
    # K rows per clip, and a second buffer for every reorder
    front = [{n: t.repeat_interleave(k, dim=0) for n, t in layer.items()}
             for layer in caches]
    del caches
    back = [{n: torch.empty_like(t) for n, t in layer.items()}
            for layer in front]
    pad_r = (pad_lens.repeat_interleave(k) if pad_lens is not None
             else None)

    tokens = torch.full((b, k, max_new_tokens), pad_id, dtype=torch.long,
                        device=dev)
    hid = torch.zeros((r, max_new_tokens, d), dtype=prefill_hidden.dtype,
                      device=dev)
    hid_back = torch.empty_like(hid)
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    pad_row = torch.full((v,), NEG_INF, dtype=torch.float32, device=dev)
    pad_row[pad_id] = 0.0
    base = torch.arange(b, device=dev)[:, None] * k

    for i in range(max_new_tokens):
        if early_exit and bool(done.all()):
            break
        hidden, logits, _ = model.decode_step(cur.reshape(r, 1), ls + i,
                                              front, pad_r)
        # the token that produced this step's hidden state
        tokens[:, :, i] = torch.where(done, pad_id, cur)
        hid[:, i] = hidden[:, 0]
        if i == max_new_tokens - 1:
            break                   # the last pick would not be recorded
        lp = torch.log_softmax(logits[:, -1, :].float(),
                               dim=-1).reshape(b, k, v)
        lp = torch.where(done[..., None], pad_row, lp)
        eos = cur == eos_id
        lp = torch.where((eos & ~done)[..., None], pad_row, lp)
        done_next = done | eos

        scores, flat_idx = _top_k((scores[..., None] + lp).reshape(b, k * v),
                                  k)
        beam_idx = flat_idx // v
        new_tok = flat_idx % v
        row_idx = (base + beam_idx).reshape(r)
        for fl, bl in zip(front, back):
            for n in fl:
                torch.index_select(fl[n], 0, row_idx, out=bl[n])
        front, back = back, front
        torch.index_select(hid, 0, row_idx, out=hid_back)
        hid, hid_back = hid_back, hid
        tokens = torch.gather(tokens, 1, beam_idx[..., None].expand(
            b, k, max_new_tokens))
        done = torch.gather(done_next, 1, beam_idx)
        cur = torch.where(done, pad_id, new_tok)

    lengths = (tokens != pad_id).sum(-1).float().clamp_min(1.0)
    final = scores / lengths ** float(length_penalty)
    best = torch.argmax(final, dim=-1)                   # (B,)
    rows = torch.arange(b, device=dev)
    best_hidden = hid[rows * k + best]
    return (tokens[rows, best], torch.cat([prefill_hidden, best_hidden],
                                          dim=1), final)
