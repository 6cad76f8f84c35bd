"""Where the int8-cache prefill of the int4 LLM spends its time, on one
NVIDIA GPU.

    python3 -m grove_tpu_torch.profile_prefill      # one card, no arguments

The prefill that `chip_smoke.py` phase 3 times for its int4 + int8 KV run:
`GroveConfig()` built from a seed, the LLM quantized to group-128 int4
(`GroveForCausalLM.quantize(bits=4)`), the CLIP tokens of 2 clips x 8
frames spliced into two grounding prompts left-padded to 2 x 640 tokens,
an int8 KV cache. (The two default prompts unpadded are 2 x 634 tokens:
634 is no multiple of 8, so their prefill takes the plain attention and no
K5; their launches are printed too.) It runs with K5 (the causal prefill
attention, once per LLaMA layer) on its tensor-core entry, as the port
routes it, and, for this comparison only, with K5's route pinned to its
SIMT entry (`ops.attention._tc_takes` answering False). For each route,
alternating:

1. CUDA-event ms of one prefill, median of 5, three rounds;
2. one prefill under `torch.profiler`: the host span (first event to last),
   the device's busy time (the union of its kernel and copy intervals),
   the idle share of the span, the kernel count, K5's device time and the
   kernels with the most device time.

Prints the card's name and power limit first. Exits non-zero without CUDA.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch

TOP = 10                 # kernels printed per route
# chip_smoke.py's two questions (left-padded), and its two default prompts
PROMPTS = (None, "describe what happens in the video please")
DEFAULT_PROMPTS = (None, None)


def _ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace(fn, label: str, gpu: str) -> None:
    """One call of `fn` under torch.profiler: host span, device busy time,
    idle share, kernels, K5's device time, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        print(f"{label}: the profiler recorded no device events ({gpu})",
              flush=True)
        return
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    span = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in device]) / 1e3
    k5 = [e for e in device if "prefill_attention" in e.name]
    k5_ms = sum(e.time_range.end - e.time_range.start for e in k5) / 1e3
    print(f"{label}: host span {span:.3f} ms, device busy {busy:.3f} ms, "
          f"idle {1 - busy / span:.4f} of the span; {len(device)} device "
          f"events; K5 {len(k5)} launches, {k5_ms:.3f} ms ({gpu})",
          flush=True)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: float(getattr(e, "self_device_time_total", 0.0)),
              reverse=True)
    for e in rows[:TOP]:
        us = float(getattr(e, "self_device_time_total", 0.0))
        print(f"    {us / 1e3:9.3f} ms  {e.count:5d} x  {e.key[:100]}")
    sys.stdout.flush()


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_prefill: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from . import _kernels
    from .api import GroveForCausalLM
    from .infer.sliding import center_prompts
    from .ops import attention
    from .text.mock_tokenizer import MockTokenizer

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    _kernels.build()
    _kernels.load()
    torch.backends.cuda.matmul.allow_tf32 = False

    lm = GroveForCausalLM.from_pretrained(None, "full", device="cuda",
                                          dtype=torch.bfloat16, seed=0)
    lm.quantize(bits=4)
    model, cfg = lm.model, lm.cfg
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    rng = np.random.default_rng(1)
    c, nf = cfg.clip.image_size, cfg.num_frames
    fc = torch.from_numpy(rng.integers(0, 256, (2, nf, c, c, 3), np.uint8)
                          ).to("cuda")
    tc_takes = attention._tc_takes
    routes = {"tensor-core": tc_takes, "SIMT": lambda dtype, d: False}
    with torch.inference_mode():
        emb, _ = model.encode_video(fc)

        def prefill_of(prompts):
            ids, starts, pads = center_prompts(cfg, tok, list(prompts))
            ids_t = torch.from_numpy(ids).to("cuda")
            pads_t = None if pads is None else torch.from_numpy(pads).to(
                "cuda")
            caches = model.model.init_kv_caches(2, ids.shape[1],
                                                dtype=torch.int8,
                                                device="cuda")
            print(f"int4 + int8 KV prefill of {tuple(ids.shape)} tokens, "
                  f"pads {pads}: {cfg.llama.num_layers} LLaMA layers",
                  flush=True)
            return lambda: model.prefill(ids_t, emb, starts, caches,
                                         pad_lens=pads_t)

        try:
            for prompts in (PROMPTS, DEFAULT_PROMPTS):
                fn = prefill_of(prompts)
                for name, route in routes.items():
                    attention._tc_takes = route
                    _kernels.reset_launch_counts()
                    fn()
                    torch.cuda.synchronize()
                    ran = {k: v.launches
                           for k, v in _kernels.KERNELS.items()
                           if v.launches}
                    print(f"  K5 routed to its {name} entry: launches "
                          f"{ran}", flush=True)
            prefill = prefill_of(PROMPTS)
            times = {name: [] for name in routes}
            for _ in range(3):
                for name, route in routes.items():
                    attention._tc_takes = route
                    times[name].append(_ms(prefill))
            for name, t in times.items():
                print(f"K5 on its {name} entry: prefill "
                      f"{', '.join(f'{x:.3f}' for x in t)} ms (CUDA events, "
                      f"median of 5, three rounds; {gpu})", flush=True)
            for name, route in routes.items():
                attention._tc_takes = route
                trace(prefill, f"K5 on its {name} entry, traced", gpu)
        finally:
            attention._tc_takes = tc_takes
    return 0


if __name__ == "__main__":
    sys.exit(main())
