"""Continuous batching: requests join and leave one resident decode loop.

Counterpart of `grove_tpu/serve/continuous.py` (`ContinuousEngine`,
`ContinuousService`). The batching engine of `server.py` runs whole groups
of requests per call; a request that arrives mid-decode waits for the
group. This engine keeps one resident KV cache of `n_slots` rows and
`capacity` columns and admits new requests between ticks:

  * one global cache column `col`: every tick writes all slots' K/V there
    and advances it;
  * admission prefills the prompt, bucketed to a multiple of
    `prompt_bucket` and left-padded, at batch 1 into its own (1, Lb) cache,
    and copies the slab into columns [col - Lb, col) of the slot's row, in
    either cache layout (bf16 (B, C, H, D), or int8 (B, H, C, D) with
    (B, H, C) scales); the slot's `pad_lens` becomes col - Lb + pad, so its
    RoPE positions and masks are those of an offline left-padded decode;
  * each tick decodes every slot at M = n_slots rows, with per-slot
    `pad_lens`, `steps` and `budget`, the write index into the token and
    hidden buffers clamped to max_new - 1;
  * EOS or the budget finishes a slot: its prompt hidden states and the
    per-step ones feed the [DET] gather and the grounding head, as in
    `generate_grounded`;
  * once `col` leaves too little room the engine admits nothing more; once
    idle it rewinds `col` (a soft reset: the stale columns stay masked).

`capacity` must exceed 4 * max_new_tokens, the decode horizon that the
start column leaves; the engine raises ValueError otherwise (the JAX
engine accepts it and then fails every admission, ROADMAP "Known
faults"). Every entry runs under `torch.inference_mode()`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import GroveConfig
from ..models.grove import GroveModel
from ..text.packing import det_gather_positions
from .server import OverloadedError, _jsonable, model_context


@dataclasses.dataclass
class _Slot:
    request_id: int = -1
    prompt_ids: Optional[np.ndarray] = None      # unpadded (Lp,)
    prompt_hidden: Optional[torch.Tensor] = None  # (Lp, D)
    image_embeddings: Optional[torch.Tensor] = None  # (T, HW, C)
    active: bool = False


def _bucket(n: int, bucket: int) -> int:
    return -(-n // bucket) * bucket


class ContinuousEngine:
    """Slot-based continuous greedy decode over one resident KV cache."""

    def __init__(self, model: GroveModel, cfg: GroveConfig, *,
                 n_slots: int = 4, capacity: int = 0,
                 max_new_tokens: int = 64, prompt_bucket: int = 64,
                 cache_dtype: Optional[torch.dtype] = None):
        self.model = model
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_new = max_new_tokens
        self.bucket = prompt_bucket
        # bf16 when None, whatever the model's dtype, as JAX's default
        # (`continuous.py:71`)
        self.cache_dtype = cache_dtype or torch.bfloat16
        # room for the longest prompt plus a decode horizon of several
        # request generations before a rewind
        self.capacity = capacity or (cfg.spliced_seq_len
                                     + 4 * max_new_tokens)
        if self.capacity <= 4 * max_new_tokens:
            raise ValueError(
                f"capacity {self.capacity} leaves no admission window: it "
                f"must exceed 4 * max_new_tokens = {4 * max_new_tokens}")
        self._slots = [_Slot() for _ in range(n_slots)]
        self._results: Dict[int, Dict] = {}
        dev, b = model.device, n_slots
        with torch.inference_mode():
            self.caches = model.model.init_kv_caches(
                b, self.capacity, dtype=self.cache_dtype, device=dev)
            self.cur_tok = torch.zeros((b,), dtype=torch.long, device=dev)
            self.done = torch.ones((b,), dtype=torch.bool, device=dev)
            self.pad_lens = torch.zeros((b,), dtype=torch.long, device=dev)
            self.steps = torch.zeros((b,), dtype=torch.long, device=dev)
            self.budget = torch.zeros((b,), dtype=torch.long, device=dev)
            self.gen = torch.zeros((b, max_new_tokens), dtype=torch.long,
                                   device=dev)
            self.hid = torch.zeros((b, max_new_tokens,
                                    cfg.llama.hidden_size),
                                   dtype=model.dtype, device=dev)
        self._soft_reset()

    @property
    def start_col(self) -> int:
        """Where `col` starts: prompts go to its left, so it is the
        widest prompt bucket the engine admits."""
        return self.capacity - 4 * self.max_new

    @torch.inference_mode()
    def _soft_reset(self):
        self.done.fill_(True)
        self.cur_tok.zero_()
        self.steps.zero_()
        self.col = self.start_col

    # ------------------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if not s.active]

    def active(self) -> bool:
        return any(s.active for s in self._slots)

    def can_admit(self, bucket_len: int) -> bool:
        return (bool(self.free_slots())
                and self.col - bucket_len >= 0
                and self.col + self.max_new <= self.capacity)

    @torch.inference_mode()
    def admit(self, request_id: int, spliced_ids, video_embeds,
              video_start: int, image_embeddings,
              max_new: Optional[int] = None) -> int:
        """Prefill one request and arm a free slot. `spliced_ids` (Lp,)
        unpadded; `image_embeddings` (T, HW, C) for the grounding head."""
        ids = np.asarray(spliced_ids, np.int64)
        lp = len(ids)
        lb = _bucket(lp, self.bucket)
        if not self.can_admit(lb):
            raise RuntimeError("no capacity (drain in progress?)")
        slot = self.free_slots()[0]
        pad = lb - lp
        dev = self.model.device
        ids_b = np.full((1, lb), int(self.cfg.tokens.pad), np.int64)
        ids_b[0, pad:] = ids
        slab = self.model.model.init_kv_caches(1, lb,
                                               dtype=self.cache_dtype,
                                               device=dev)
        hidden, logits, slab = self.model.prefill(
            torch.from_numpy(ids_b).to(dev), video_embeds,
            [int(video_start) + pad], slab,
            torch.full((1,), pad, dtype=torch.long, device=dev))
        c0, c1 = self.col - lb, self.col
        for layer_slab, layer in zip(slab, self.caches):
            int8_layout = "k_s" in layer
            for key, buf in layer.items():
                if int8_layout:                  # the width is dim 2
                    buf[slot, :, c0:c1] = layer_slab[key][0, :, :lb]
                else:
                    buf[slot, c0:c1] = layer_slab[key][0]
        self.cur_tok[slot] = torch.argmax(logits[0, -1], dim=-1)
        self.done[slot] = False
        self.pad_lens[slot] = c0 + pad
        self.steps[slot] = 0
        self.budget[slot] = min(max_new or self.max_new, self.max_new)
        self.gen[slot] = 0
        self.hid[slot] = 0
        self._slots[slot] = _Slot(request_id, ids, hidden[0, pad:].clone(),
                                  image_embeddings, True)
        return slot

    @torch.inference_mode()
    def tick(self) -> List[int]:
        """One decode step for every slot; returns the request ids that
        finished."""
        if not self.active():
            return []
        cfg = self.cfg
        eos, pad = int(cfg.tokens.eos), int(cfg.tokens.pad)
        tok, done = self.cur_tok, self.done
        hidden, logits, _ = self.model.decode_step(tok[:, None], self.col,
                                                   self.caches,
                                                   self.pad_lens)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        idx = torch.arange(self.n_slots, device=tok.device)
        # `steps` counts emitted tokens (it reaches max_new); the write
        # index is clamped apart from it
        widx = self.steps.clamp(max=self.max_new - 1)
        self.gen[idx, widx] = torch.where(done, self.gen[idx, widx], tok)
        self.hid[idx, widx] = torch.where(done[:, None],
                                          self.hid[idx, widx],
                                          hidden[:, 0].to(self.hid.dtype))
        self.steps = torch.where(done, self.steps, self.steps + 1)
        self.done = done | (tok == eos) | (self.steps >= self.budget)
        self.cur_tok = torch.where(self.done, pad, nxt)
        self.col += 1
        done_host = self.done.tolist()
        finished = []
        for i, s in enumerate(self._slots):
            if s.active and done_host[i]:
                finished.append(s.request_id)
                self._finish(i)
        return finished

    def _finish(self, slot: int):
        s = self._slots[slot]
        steps = int(self.steps[slot])
        # a copy: on the CPU .numpy() would alias the slot's buffer
        gen = self.gen[slot, :steps].cpu().numpy().copy()
        full_ids = np.concatenate([s.prompt_ids, gen])
        hidden = torch.cat([s.prompt_hidden, self.hid[slot, :steps]])
        det_pos, mask = det_gather_positions(full_ids, self.cfg.tokens.det,
                                             self.cfg.max_phrases)
        boxes, obj = self.model.ground(
            hidden[None], torch.as_tensor(det_pos[None],
                                          device=hidden.device),
            s.image_embeddings)
        self._results[s.request_id] = {
            "generated_ids": gen,
            "full_ids": full_ids,
            "pred_boxes": boxes[0].float().cpu().numpy(),
            "objectness_logits": (obj[0].float().cpu().numpy()
                                  if obj is not None else None),
            "phrase_mask": np.asarray(mask),
            "steps": steps,
        }
        self._slots[slot] = _Slot()
        if not self.active():
            self._soft_reset()              # idle: rewind the column

    def pop_result(self, request_id: int) -> Optional[Dict]:
        return self._results.pop(request_id, None)

    def run_until_idle(self, max_ticks: Optional[int] = None) -> List[int]:
        out, ticks = [], 0
        while self.active():
            out.extend(self.tick())
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        return out

    def fail_active(self) -> List[int]:
        """Drop every active slot (after a failed tick) and rewind; returns
        their request ids."""
        ids = [s.request_id for s in self._slots if s.active]
        self._slots = [_Slot() for _ in range(self.n_slots)]
        self._soft_reset()
        return ids


# ---------------------------------------------------------------------------
# the threaded service (the BatchingEngine surface)
# ---------------------------------------------------------------------------

class ContinuousService:
    """Drop-in alternative to `server.BatchingEngine`: the same `submit`,
    with requests streaming through one resident decode loop. Greedy only
    (per-slot sampling state does not run in lockstep): other decode knobs
    and another cache dtype are rejected, so that callers use the batch
    engine.

    Threads: a request's own thread decodes and preprocesses its clip and
    runs the encoders; one loop thread owns the engine (admissions between
    ticks, each prefill outside the lock) and hands results back through
    events."""

    def __init__(self, processor, model, *, n_slots: int = 4,
                 max_new_tokens: int = 64, prompt_bucket: int = 64,
                 capacity: int = 0,
                 cache_dtype: Optional[torch.dtype] = None):
        self.processor = processor
        self.model = model
        self.max_new = max_new_tokens
        self.engine = ContinuousEngine(model, processor.cfg, n_slots=n_slots,
                                       max_new_tokens=max_new_tokens,
                                       prompt_bucket=prompt_bucket,
                                       capacity=capacity,
                                       cache_dtype=cache_dtype)
        self.max_queue = 256
        self._pending: list = []
        self._events: Dict[int, threading.Event] = {}
        self._gen_results: Dict[int, object] = {}
        self._abandoned: set = set()
        self._next_id = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.requests_served = 0
        self.batches_run = 0          # ticks run (the surface's counter)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, payload: Dict, timeout: float = 300.0) -> Dict:
        # anything that would change the greedy program is rejected
        # (temperature=1.0 turns sampling on); inert knobs pass
        unsupported = []
        if (payload.get("temperature") or 0.0) > 0.0:
            unsupported.append("temperature")
        if (payload.get("top_k") or 0) > 0:
            unsupported.append("top_k")
        if payload.get("top_p") is not None and payload["top_p"] < 1.0:
            unsupported.append("top_p")
        if (payload.get("num_beams") or 1) > 1:
            unsupported.append("num_beams")
        if payload.get("kv_cache_dtype") not in (None, "bf16", "bfloat16"):
            unsupported.append("kv_cache_dtype")
        if unsupported:
            raise ValueError(
                f"continuous batching serves greedy decode only; "
                f"unsupported knobs: {unsupported} (use the batch engine)")
        mn = min(int(payload.get("max_new_tokens") or self.max_new),
                 self.max_new)
        with model_context(self.model):
            out = self.processor.generate_with_backend(
                self.model, payload["video_path"],
                self._decode_backend(timeout, mn),
                instruction=payload.get("instruction"),
                temp_objectness_threshold=payload.get(
                    "temp_objectness_threshold"))
        with self._lock:
            self.requests_served += 1
        return _jsonable(out)

    def close(self):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)

    # -- the decode backend handed to infer_clip ------------------------

    def _decode_backend(self, timeout: float, max_new: int):
        def backend(spliced_ids, video_start, fc, fs):
            ve, _ = self.model.encode_video(fc)
            img = self.model.encode_grounding_auto(fs)
            # a prompt whose bucket exceeds the admission window would
            # wait forever: reject it here
            lb = _bucket(len(spliced_ids), self.engine.bucket)
            if lb > self.engine.start_col:
                raise ValueError(
                    f"prompt bucket {lb} exceeds the engine's admission "
                    f"window {self.engine.start_col} (capacity "
                    f"{self.engine.capacity}); raise `capacity`")
            ev = threading.Event()
            with self._lock:
                if len(self._pending) >= self.max_queue:
                    raise OverloadedError("server overloaded, retry later")
                rid = self._next_id
                self._next_id += 1
                self._events[rid] = ev
                self._pending.append((rid, np.asarray(spliced_ids), ve,
                                      int(video_start), img, max_new))
            self._wake.set()
            if not ev.wait(timeout):
                with self._lock:
                    # never admit it, never keep its result
                    self._events.pop(rid, None)
                    was_pending = any(p[0] == rid for p in self._pending)
                    self._pending = [p for p in self._pending
                                     if p[0] != rid]
                    if not was_pending:
                        # admitted: the loop drops its result at finish
                        self._abandoned.add(rid)
                    self._gen_results.pop(rid, None)
                raise TimeoutError("continuous decode timed out")
            with self._lock:
                res = self._gen_results.pop(rid)
            if isinstance(res, Exception):
                raise res
            # the generate_grounded dict surface
            return {
                "generated_ids": res["generated_ids"][None],
                "pred_boxes": res["pred_boxes"][None],
                "objectness_logits": (
                    res["objectness_logits"][None]
                    if res["objectness_logits"] is not None else None),
                "phrase_mask": res["phrase_mask"][None],
            }
        return backend

    # -- the loop thread --------------------------------------------------

    def _deliver(self, rid: int, res):
        """Hand a result or an exception to its waiter (under the lock)."""
        ev = self._events.pop(rid, None)
        if ev:
            self._gen_results[rid] = res
            ev.set()
        else:
            self._abandoned.discard(rid)        # its waiter gave up

    def _admit_pending(self) -> bool:
        admitted = False
        while self.engine.free_slots():
            # pop under the lock, prefill outside it
            with self._lock:
                job = None
                if self._pending:
                    lb = _bucket(len(self._pending[0][1]),
                                 self.engine.bucket)
                    if self.engine.can_admit(lb):
                        job = self._pending.pop(0)
            if job is None:
                break
            rid, ids, ve, vstart, img, mn = job
            try:
                self.engine.admit(rid, ids, ve, vstart, img, max_new=mn)
                admitted = True
            except Exception as e:                       # noqa: BLE001
                with self._lock:
                    self._deliver(rid, e)
        return admitted

    def _loop(self):
        with model_context(self.model):
            while not self._stop.is_set():
                admitted = self._admit_pending()
                if not self.engine.active() and not admitted:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                try:
                    finished = self.engine.tick()
                except Exception as e:                   # noqa: BLE001
                    # the loop must not die: fail the slots in flight
                    with self._lock:
                        for rid in self.engine.fail_active():
                            self._deliver(rid, e)
                    continue
                self.batches_run += 1
                if finished:
                    with self._lock:
                        for rid in finished:
                            self._deliver(rid, self.engine.pop_result(rid))
