"""Serving layer: an HTTP endpoint with dynamic micro-batching.

Counterpart of `grove_tpu/serve/server.py`. A threaded HTTP server hands
every request to one batcher thread, which groups up to `max_batch` clips
(whatever arrived within `batch_timeout_ms`) whose decode knobs agree into
one `GroveProcessor.generate_batch` call: the left-padded lockstep decode
makes ragged per-request instructions batchable. One batcher thread means
one model call in flight: requests queue on the host and the card's work
amortizes over concurrent callers.

Endpoints (JSON over the stdlib http.server):
  GET  /healthz            -> {"status": "ok", "model": ..., "batches_run",
                               "requests_served"}
  POST /generate           -> the processor's output dict
    body: {"video_path": ..., "instruction"?, "max_new_tokens"?,
           "temperature"?, "top_k"?, "top_p"?, "seed"?, "num_beams"?,
           "length_penalty"?, "kv_cache_dtype"?, "early_stop"?,
           "temp_objectness_threshold"?}

`video_path` is a path the server can read. The port's model holds its
weights, so the JAX signatures' `variables` argument is gone. The batcher
thread runs under `torch.inference_mode()` (grad mode is per thread) with
the model's device current.

    python -m grove_tpu_torch.serve.server --model_size full [--continuous]
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

_KNOBS = ("instruction", "max_new_tokens", "temperature", "top_k", "top_p",
          "seed", "num_beams", "kv_cache_dtype", "early_stop",
          "length_penalty", "temp_objectness_threshold")

MAX_NEW_TOKENS_CAP = 512

# `GroveProcessor.generate_batch` defaults, which normalize the knob keys:
# an explicitly passed default ({"top_p": 1.0}) batches with the absent key
_KNOB_DEFAULTS = {
    "max_new_tokens": 64, "temperature": 0.0, "top_k": 0, "top_p": 1.0,
    "seed": None, "num_beams": 1, "length_penalty": 1.0,
    "kv_cache_dtype": None, "early_stop": True,
    "temp_objectness_threshold": None,
}

# request-body cap: a payload is a path and a few scalar knobs
MAX_BODY_BYTES = 1 << 20


def validate_payload(payload: Dict) -> None:
    """Reject a bad request before it reaches the batcher thread (an
    unchecked max_new_tokens would run an arbitrarily long decode and stall
    every queued client): the types, the token cap, then the knob
    combinations of `api.processor._decode_kwargs`. Raises ValueError."""
    from ..api.processor import _decode_kwargs
    if "video_path" not in payload:
        raise ValueError("video_path required")
    if not isinstance(payload["video_path"], str):
        raise ValueError(f"video_path must be a string, got "
                         f"{type(payload['video_path']).__name__}")
    mnt = payload.get("max_new_tokens")
    if mnt is not None:
        if (isinstance(mnt, bool) or not isinstance(mnt, int)
                or not 1 <= mnt <= MAX_NEW_TOKENS_CAP):
            raise ValueError(f"max_new_tokens must be an int in "
                             f"[1, {MAX_NEW_TOKENS_CAP}], got {mnt!r}")
    for key, typ in (("temperature", (int, float)), ("top_k", int),
                     ("top_p", (int, float)), ("seed", int),
                     ("num_beams", int), ("length_penalty", (int, float)),
                     ("early_stop", bool), ("kv_cache_dtype", str),
                     ("instruction", str),
                     ("temp_objectness_threshold", (int, float))):
        val = payload.get(key)
        if val is None:
            continue
        # bool is a subclass of int: {"top_k": true} must not pass as 1
        if isinstance(val, bool) and typ is not bool:
            raise ValueError(f"{key} must be {typ}, got bool")
        if not isinstance(val, typ):
            raise ValueError(f"{key} must be {typ}, got {type(val).__name__}")

    def _get(key, default):                 # JSON null means the default
        val = payload.get(key)
        return default if val is None else val

    _decode_kwargs(payload.get("kv_cache_dtype"), _get("early_stop", True),
                   _get("temperature", 0.0), _get("top_k", 0),
                   _get("top_p", 1.0), payload.get("seed"),
                   _get("num_beams", 1), _get("length_penalty", 1.0))


def _jsonable(out: Dict) -> Dict:
    """A processor output dict (numpy arrays inside) as JSON values."""
    res = {}
    for k, v in out.items():
        if isinstance(v, np.ndarray):
            res[k] = v.tolist()
        elif isinstance(v, (list, tuple)):
            res[k] = [x.tolist() if isinstance(x, np.ndarray) else x
                      for x in v]
        else:
            res[k] = v
    return res


def model_context(model):
    """What every engine thread runs under: `torch.inference_mode()` (no
    autograd history in the KV caches) with the model's card current (the
    kernel wrappers launch on the current stream)."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode())
    dev = getattr(model, "device", None)
    if dev is not None and dev.type == "cuda":
        stack.enter_context(torch.cuda.device(dev))
    return stack


class OverloadedError(RuntimeError):
    """Raised when the request queue is full (HTTP 503)."""


class _Pending:
    __slots__ = ("payload", "event", "result", "error", "abandoned")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False   # set when the submitter gave up waiting


class BatchingEngine:
    """Groups concurrent /generate requests into one model call.

    Requests batch together only when their decode knobs agree; the
    batcher drains the queue and splits it into knob groups, largest
    first."""

    def __init__(self, processor, model, *, max_batch: int = 8,
                 batch_timeout_ms: float = 10.0, max_queue: int = 256,
                 pad_batches: bool = False):
        self.processor = processor
        self.model = model
        self.max_batch = max_batch
        # pad every group to max_batch by repeating the last clip (the
        # extras are dropped): one decode shape for every group size
        self.pad_batches = pad_batches
        self.batch_timeout = batch_timeout_ms / 1000.0
        # bounded: a flood sheds load (503) at the door instead of piling
        # up on the host until the submit timeout drains it
        self.queue: "queue.Queue[_Pending]" = queue.Queue(maxsize=max_queue)
        self.batches_run = 0
        self.requests_served = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, payload: Dict, timeout: float = 300.0) -> Dict:
        p = _Pending(payload)
        try:
            self.queue.put_nowait(p)
        except queue.Full:
            raise OverloadedError("server overloaded, retry later") from None
        if not p.event.wait(timeout):
            # the batcher drops it instead of running a result nobody reads
            p.abandoned = True
            raise TimeoutError("generation timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _drain(self) -> List[_Pending]:
        """Block for one request, then take whatever else arrives within
        the batching window (up to max_batch)."""
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.batch_timeout
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    @staticmethod
    def _knob_key(payload: Dict) -> str:
        """Hashable grouping key; the JSON round trip takes any client
        value (lists and dicts included) without crashing the batcher.

        Knobs are normalized through `_KNOB_DEFAULTS`, so that explicit
        defaults group with absent keys, and a seed on a greedy request
        (inert, dropped by `_decode_kwargs`) is dropped here too."""
        vals = {}
        for k, default in _KNOB_DEFAULTS.items():
            v = payload.get(k)
            v = default if v is None else v
            # JSON clients send float knobs as ints ({"top_p": 1}); bools
            # never reach here (validate_payload rejects them)
            if isinstance(default, float) and isinstance(v, int):
                v = float(v)
            if v != default:
                vals[k] = v
        if not vals.get("temperature"):
            vals.pop("seed", None)
        return json.dumps(vals, sort_keys=True, default=str)

    def _loop(self):
        with model_context(self.model):
            while not self._stop.is_set():
                batch: List[_Pending] = []
                try:
                    batch = [p for p in self._drain() if not p.abandoned]
                    if not batch:
                        continue
                    groups: Dict[str, List[_Pending]] = {}
                    for p in batch:
                        groups.setdefault(self._knob_key(p.payload),
                                          []).append(p)
                    for group in sorted(groups.values(), key=len,
                                        reverse=True):
                        self._run_group(group)
                except Exception as e:                   # noqa: BLE001
                    # the batcher thread must not die: fail what was in
                    # flight and keep serving
                    for p in batch:
                        if not p.event.is_set():
                            p.error = e
                            p.event.set()

    def _run_group(self, group: List[_Pending], *, isolate: bool = True):
        # a request can time out while queued behind other groups
        group = [p for p in group if not p.abandoned]
        if not group:
            return
        try:
            # JSON null == absent: {"temperature": null} means the default
            kwargs = {k: group[0].payload[k] for k in _KNOBS
                      if k != "instruction"
                      and group[0].payload.get(k) is not None}
            paths = [p.payload["video_path"] for p in group]
            instructions = [p.payload.get("instruction") for p in group]
            n_real = len(paths)
            if self.pad_batches and n_real < self.max_batch:
                pad_n = self.max_batch - n_real
                paths = paths + [paths[-1]] * pad_n
                instructions = instructions + [instructions[-1]] * pad_n
            if all(i is None for i in instructions):
                instructions = None
            outs = self.processor.generate_batch(
                self.model, paths, instructions=instructions,
                **kwargs)[:n_real]
            self.batches_run += 1
            self.requests_served += len(group)
            for p, out in zip(group, outs):
                p.result = _jsonable(out)
                p.event.set()
        except Exception as e:                           # noqa: BLE001
            if isolate and len(group) > 1:
                # one bad clip must not fail its neighbours: retry each
                # request alone, so only the culprit fails
                for p in group:
                    self._run_group([p], isolate=False)
            else:
                for p in group:
                    p.error = e
                    p.event.set()


class GroveServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, engine, model_name: str):
        self.engine = engine
        self.model_name = model_name
        super().__init__(addr, _Handler)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):                           # quiet by default
        pass

    def _send(self, code: int, obj: Dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            eng = self.server.engine
            self._send(200, {
                "status": "ok", "model": self.server.model_name,
                "batches_run": eng.batches_run,
                "requests_served": eng.requests_served,
            })
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        if self.path != "/generate":
            self._send(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > MAX_BODY_BYTES:
                self._send(413, {"error": f"request body too large "
                                          f"({n} > {MAX_BODY_BYTES} bytes)"})
                return
            payload = json.loads(self.rfile.read(n) or b"{}")
            try:
                validate_payload(payload)
            except ValueError as e:
                self._send(400, {"error": str(e)})
                return
            out = self.server.engine.submit(payload)
            self._send(200, out)
        except TimeoutError as e:
            self._send(504, {"error": str(e)})
        except OverloadedError as e:
            self._send(503, {"error": str(e)})
        except FileNotFoundError as e:
            self._send(400, {"error": str(e)})
        except ValueError as e:
            self._send(400, {"error": str(e)})
        except Exception as e:                           # noqa: BLE001
            self._send(500, {"error": f"{type(e).__name__}: {e}"})


def serve(processor, model, *, host: str = "127.0.0.1", port: int = 8470,
          max_batch: int = 8, batch_timeout_ms: float = 10.0,
          model_name: str = "grove_tpu_torch", pad_batches: bool = False):
    """Build (server, engine); call server.serve_forever() to run, then
    server.shutdown(), server.server_close() and engine.close()."""
    engine = BatchingEngine(processor, model, max_batch=max_batch,
                            batch_timeout_ms=batch_timeout_ms,
                            pad_batches=pad_batches)
    try:
        server = GroveServer((host, port), engine, model_name)
    except BaseException:
        engine.close()
        raise
    return server, engine


def _parser():
    import argparse
    p = argparse.ArgumentParser("grove_tpu_torch.serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8470, type=int)
    p.add_argument("--device", default="cuda",
                   help="the model's device (cuda unless asked otherwise)")
    p.add_argument("--model_size", default="small",
                   choices=["tiny", "small", "full"])
    p.add_argument("--version", default=None,
                   help="checkpoint: a reference torch .bin, a model "
                        "directory (the port's save_pretrained or the JAX "
                        "package's flax_model.msgpack) or a training log "
                        "directory (the port's or Orbax; random weights "
                        "from seed 0 if omitted)")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer path (MockTokenizer if omitted)")
    p.add_argument("--max_batch", default=8, type=int)
    p.add_argument("--batch_timeout_ms", default=10.0, type=float)
    p.add_argument("--pad_batches", action="store_true",
                   help="pad every group to max_batch (one decode shape)")
    p.add_argument("--quantize_llm", action="store_true",
                   help="weight-only quantized LLM (GroveForCausalLM."
                        "quantize)")
    p.add_argument("--llm_bits", default=8, type=int, choices=(8, 4),
                   help="LLM weight width with --quantize_llm: 8 "
                        "(per-channel int8) or 4 (group-128 int4, int8 "
                        "lm_head)")
    p.add_argument("--llm_act_quant", action="store_true",
                   help="dynamic int8 LLM activations with --quantize_llm")
    p.add_argument("--quantize_vision", action="store_true",
                   help="W8A8 int8 CLIP and SAM towers")
    p.add_argument("--fused_qkv", action="store_true",
                   help="fuse the qkv and gate_up projections "
                        "(GroveForCausalLM.fuse)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: requests join and leave one "
                        "resident decode loop (greedy only; "
                        "serve/continuous.py)")
    p.add_argument("--n_slots", default=4, type=int,
                   help="decode slots for --continuous")
    return p


def build(argv: Optional[List[str]] = None):
    """The server `main` runs, from its flags: (server, engine)."""
    from ..api.model import GroveForCausalLM
    from ..api.processor import GroveProcessor
    args = _parser().parse_args(argv)
    if args.tokenizer:
        from ..text.tokenizer import load_grove_tokenizer
        tok = load_grove_tokenizer(args.tokenizer)
    else:
        from ..text.mock_tokenizer import MockTokenizer
        tok = MockTokenizer()
    lm = GroveForCausalLM.from_pretrained(args.version,
                                          model_size=args.model_size,
                                          tokenizer=tok, device=args.device)
    if args.quantize_llm or args.quantize_vision:
        lm = lm.quantize(vision=args.quantize_vision, bits=args.llm_bits,
                         act_quant=args.llm_act_quant)
    if args.fused_qkv:
        lm = lm.fuse()
    proc = GroveProcessor(tok, lm.cfg)
    if not args.continuous:
        return serve(proc, lm.model, host=args.host, port=args.port,
                     max_batch=args.max_batch,
                     batch_timeout_ms=args.batch_timeout_ms,
                     model_name=f"grove-{args.model_size}",
                     pad_batches=args.pad_batches)
    from .continuous import ContinuousService
    engine = ContinuousService(proc, lm.model, n_slots=args.n_slots)
    try:
        server = GroveServer((args.host, args.port), engine,
                             f"grove-{args.model_size}-continuous")
    except BaseException:
        engine.close()
        raise
    return server, engine


def main(argv: Optional[List[str]] = None):
    server, engine = build(argv)
    host, port = server.server_address[:2]
    print(f"serving {server.model_name} on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
