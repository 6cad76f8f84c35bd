#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (grove_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # one card, no arguments

Phases, each printing its own line; any failure exits non-zero:
  0  device: requires CUDA (there is no CPU path) and prints the card's
     name and power limit as nvidia-smi reports them;
  1  build: compiles grove_tpu_torch/csrc with nvcc for sm_90a;
  2  kernels: each hand-written kernel against its plain torch twin on the
     card, at the full-width shapes of the main paths in bf16 (max-abs
     error <= 2e-2 of the output's max-abs, for flash_forward_lse of the
     LSE's too) and at small fp32 shapes (<= 1e-4), with median CUDA-event
     times of both. One fp32 K1 case carries an all-underflow row, which
     must come out as exact zeros (the TPU kernel's EXP2_SHIFT contract).
     K6 and K7a take microseconds and read inputs that are cold in the
     model (every layer has its own cache and weights), so they are timed
     as CUDA-graph replays over copies of more than 64 MiB, beyond the
     50 MB L2 (eager calls between events would time the host's launch
     overhead). K7a has three full-width shapes
     (the q/k/v/o, gate/up and down projections of a decode step); its
     JSON times are their sum;
  3  slice: GroveConfig() (CLIP ViT-L/336, SAM ViT-H/512, LLaMA-7B) built
     on the card from a seed (GroveForCausalLM.from_pretrained), first in
     bf16, then quantized in place (quantize(bits=4): int4 projections,
     int8 lm_head) and run with the int8 KV cache. Each run drives
     infer_clips_batched on 2 synthetic 24-frame clips (64 new tokens) and
     ground_clip_with_caption with the launch counts zeroed just before and
     read just after; outputs must carry the JAX package's keys and be
     finite, the bf16 run must launch K1-K4 and the quantized run K1-K7a.
     Then a timed replay of the stages, peak device memory and weight
     bytes of both, and how many greedy tokens the quantized replay shares
     with the bf16 one;
  4  parity: GroveConfig.small() in fp32, one set of weights, on the card
     with the kernels and on the CPU with the plain versions (TF32 off):
     teacher-forced boxes and objectness within 1e-3, greedy token
     agreement; then the same with the LLM quantized to int4: boxes within
     1e-3, and the CPU's greedy ids fed to both through prefill and 16
     decode steps over an int8 cache, each step's hidden states within
     1e-2 of their max-abs (one int8 LSB of K/V may flip between the two).

The line before the last is a JSON object with each kernel's measurements
(`launches`: K1-K4 from the bf16 run of phase 3, K5-K7a from the quantized
one); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_TOL = 2e-2          # bf16, relative to the plain output's max-abs
FP32_TOL = 1e-4          # fp32, absolute
PARITY_TOL = 1e-3        # phase 4 boxes / objectness
STEP_TOL = 1e-2          # phase 4 int8-cache decode steps, of max-abs
COLD_BYTES = 64 * 2**20  # inputs cycled past the L2 when timing cold kernels
QUANT_KERNELS = ("prefill_attention", "int8_decode_attention", "int4_matmul")
CAPTION = "a person is slicing tomatoes on a wooden board"


class PhaseError(RuntimeError):
    pass


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 0 / 1
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false: this script "
                         "needs an NVIDIA GPU; there is no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    gpu = smi.stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    say(0, f"device {torch.cuda.get_device_name(0)}, "
           f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
           f"cuda {torch.version.cuda}")
    return gpu


def phase_build():
    from grove_tpu_torch import _kernels
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.load()
    say(1, f"built {path.name} from {len(_kernels.sources())} sources in "
           f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cases(torch):
    """name -> dict(fn, plain, make(gen, dtype, shape) -> args, full
    shapes, small fp32 shapes, cold)."""
    from grove_tpu_torch.ops import (attention, decode_attention,
                                     flash_backward, int4_matmul,
                                     sam_attention)

    def randn(gen, shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def uniform(gen, shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")

    def int8s(gen, shape, lo=-127):
        return torch.randint(lo, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def k1_inputs(gen, dtype, shape):
        nw, win, heads, d = shape[:4]
        s, c = win * win, heads * d
        qkv = randn(gen, (nw, s, 3 * c), dtype)
        rel = randn(gen, (nw, s, heads * 2 * win), dtype)
        if len(shape) > 4:
            # row 0 of window 0: every logit near -800 in log2 units, far
            # below EXP2_SHIFT - 126, so the TPU kernel returns 0 there
            kq = qkv[0].view(s, 3, heads, d)
            kq[:, 1] = 1.0 + 0.3 * randn(gen, (s, heads, d), dtype)
            kq[0, 0] = -73.0
            rel[0, 0] = 0.0
        return (qkv, rel, (win, win), heads)

    def k2_inputs(gen, dtype, shape):
        b, g, heads, d = shape
        s = g * g
        q, k, v = (randn(gen, (b, s, heads, d), dtype) for _ in range(3))
        rh = randn(gen, (b, heads, s, g), dtype)
        rw = randn(gen, (b, heads, s, g), dtype)
        return (q, k, v, rh, rw, (g, g))

    def qkv_inputs(gen, dtype, shape):
        return tuple(randn(gen, shape, dtype) for _ in range(3))

    def k4(*a):
        q, k, v = a
        return flash_backward.flash_forward_lse(
            q, k, v, causal=True, scale=q.shape[-1] ** -0.5)

    def k4_plain(*a):
        q, k, v = a
        return flash_backward.flash_forward_lse_torch(
            q, k, v, causal=True, scale=q.shape[-1] ** -0.5)

    def k5_inputs(gen, dtype, shape):
        b, s, heads, d, pad = shape
        q, k, v = (randn(gen, (b, s, heads * d), dtype) for _ in range(3))
        pads = torch.tensor([0, pad][:b], device="cuda", dtype=torch.int32)
        return (q, k, v, pads, heads, d ** -0.5)

    def k6_inputs(gen, dtype, shape):
        b, h, hkv, c, d = shape
        q = randn(gen, (b, h, d), dtype)
        kt, vt = int8s(gen, (b, hkv, c, d)), int8s(gen, (b, hkv, c, d))
        ks, vs = (uniform(gen, (b, hkv, c), 0.001, 0.02).to(torch.bfloat16)
                  for _ in range(2))
        bias = torch.zeros((b, c), device="cuda")
        bias[0, c - 60:] = decode_attention.NEG_INF       # unwritten tail
        if b > 1:
            bias[1, :9] = decode_attention.NEG_INF        # a left pad
            bias[1, c - 100:] = decode_attention.NEG_INF
        return (q, kt, vt, ks, vs, bias)

    def k7a_inputs(gen, dtype, shape):
        m, k, n, g = shape
        return (randn(gen, (m, k), dtype), int8s(gen, (k // 2, n), -128),
                uniform(gen, (k // g, n), 0.001, 0.02))

    # full-width shapes of the main paths: 16 frames (2 clips x 8) of SAM
    # (9 windows each) and CLIP, 2 teacher-forced windows of LLaMA-7B, and
    # the int8-cache prefill (2 x 640 tokens) and decode step of the
    # quantized run (M = 2 rows, a 768-slot cache)
    def case(fn, plain, make, full, small, cold=False):
        return dict(fn=fn, plain=plain, make=make, full=full, small=small,
                    cold=cold)

    return {
        "sam_window_attention": case(
            sam_attention.grouped_window_attention_relpos_v3,
            sam_attention.grouped_window_attention_relpos_v3_torch,
            k1_inputs, [(144, 14, 16, 80)],
            [(4, 8, 6, 64), (3, 2, 4, 8), (2, 4, 2, 64, "underflow")]),
        "sam_global_attention": case(
            sam_attention.grouped_window_attention_relpos,
            sam_attention.grouped_window_attention_relpos_torch,
            k2_inputs, [(16, 32, 16, 80)], [(2, 16, 6, 64), (2, 4, 4, 8)]),
        "grouped_plain_attention": case(
            attention.grouped_plain_attention,
            attention.grouped_plain_attention_torch,
            qkv_inputs, [(16, 577, 16, 64)],
            [(2, 257, 8, 64), (2, 5, 4, 8)]),
        "flash_forward_lse": case(
            k4, k4_plain, qkv_inputs, [(2, 704, 32, 128)],
            [(2, 192, 12, 64), (1, 45, 4, 8)]),
        "prefill_attention": case(
            attention.prefill_attention_raw,
            attention.prefill_attention_raw_torch,
            k5_inputs, [(2, 640, 32, 128, 37)],
            [(2, 130, 4, 64, 5), (1, 45, 2, 128, 3), (2, 24, 4, 8, 5)]),
        "int8_decode_attention": case(
            decode_attention.int8_cache_decode_attention,
            decode_attention.int8_cache_decode_attention_torch,
            k6_inputs, [(2, 32, 32, 768, 128)],
            [(2, 8, 2, 256, 64), (2, 4, 4, 128, 128), (1, 12, 12, 640, 64)],
            cold=True),
        "int4_matmul": case(
            int4_matmul.int4_matmul, int4_matmul.int4_matmul_torch,
            k7a_inputs,
            [(2, 4096, 4096, 128), (2, 4096, 11008, 128),
             (2, 11008, 4096, 128)],
            [(1, 512, 384, 128), (5, 512, 384, 128), (37, 768, 256, 32),
             (3, 1024, 68, 64)],
            cold=True),
    }


def _time_ms(torch, fn, arg_sets, reps=10):
    """Median CUDA-event time of one call, cycling over `arg_sets`."""
    for i in range(2):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*arg_sets[i % len(arg_sets)])
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _graph_ms(torch, fn, arg_sets, reps=20):
    """Median device time of one call: every set of `arg_sets` called once
    inside a captured CUDA graph, the graph replayed between CUDA events.
    For kernels of a few microseconds, where timing eager calls would
    measure the host's launch overhead instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(arg_sets))
    del graph
    return statistics.median(times)


def _max_err(got, want):
    if isinstance(got, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def _nbytes(torch, args):
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


def phase_kernels(torch, gpu):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, c in _cases(torch).items():
        fn, plain, make = c["fn"], c["plain"], c["make"]
        for shape in c["small"]:
            args = make(gen, torch.float32, shape)
            got, want = fn(*args), plain(*args)
            err = _max_err(got, want)
            torch.cuda.synchronize()
            if not err <= FP32_TOL:
                raise PhaseError(f"{name} fp32 {shape}: max-abs error "
                                 f"{err:.3e} > {FP32_TOL}")
            note = ""
            if "underflow" in shape:
                row_k = float(got[0, 0].abs().max())
                row_p = float(want[0, 0].abs().max())
                if row_k != 0.0 or row_p != 0.0:
                    raise PhaseError(f"{name}: all-underflow row gives "
                                     f"{row_k:.3e} (kernel), {row_p:.3e} "
                                     "(plain), not 0")
                note = "; the all-underflow row is exactly 0 in both"
            say(2, f"{name} fp32 {shape}: max-abs error {err:.3e}{note}")
        errs, rels, ms, plain_ms = [], [], 0.0, 0.0
        for full in c["full"]:
            args = make(gen, torch.bfloat16, full)
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            # every output (flash_forward_lse: out and LSE), each relative
            # to its own max-abs
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                err = _max_err(g, w)
                scale = float(w.float().abs().max())
                if not (np.isfinite(err) and err <= FULL_TOL * scale):
                    raise PhaseError(f"{name} bf16 {full}: max-abs error "
                                     f"{err:.3e} > {FULL_TOL} x "
                                     f"{scale:.3e}")
                errs.append(err)
                rels.append(err / scale)
            n_out = len(want)
            del got, want
            sets, timer, how = [args], _time_ms, ""
            if c["cold"]:
                copies = -(-COLD_BYTES // _nbytes(torch, args))
                sets += [make(gen, torch.bfloat16, full)
                         for _ in range(copies - 1)]
                timer = _graph_ms
                how = f" (CUDA graph over {len(sets)} cold copies)"
            t, tp = timer(torch, fn, sets), timer(torch, plain, sets)
            say(2, f"{name} bf16 {full}: max-abs error "
                   f"{', '.join(f'{e:.3e}' for e in errs[-n_out:])} "
                   f"(relative "
                   f"{', '.join(f'{r:.2e}' for r in rels[-n_out:])}); "
                   f"kernel {t:.4f} ms, plain {tp:.4f} ms{how} on {gpu}")
            ms += t
            plain_ms += tp
            del args, sets
            torch.cuda.empty_cache()
        rows[name] = {"max_abs_err": max(errs), "rel_err": max(rels),
                      "ms": ms, "plain_ms": plain_ms}
    return rows


# ---------------------------------------------------------------------------
# phase 3: the full-width slice
# ---------------------------------------------------------------------------

CLIP_KEYS = {"text", "text_tagged", "phrases", "center_frame_indices",
             "frame_indices", "bboxes", "labels_per_frame",
             "probs_temp_objectness", "original_size"}
GROUND_KEYS = {"frame_indices", "bboxes", "probs_temp_objectness",
               "original_size"}


def _synthetic_clips(cfg, n, frames, seed):
    rng = np.random.default_rng(seed)
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    return [{"frames_clip": rng.integers(0, 256, (frames, c, c, 3), np.uint8),
             "frames_sam": rng.integers(0, 256, (frames, s, s, 3), np.uint8),
             "original_size": (640, 480)} for _ in range(n)]


def _check_output(out, keys, t_total, what):
    if set(out) != keys:
        raise PhaseError(f"{what}: keys {sorted(out)} != {sorted(keys)}")
    if sorted(out["frame_indices"]) != list(range(t_total)):
        raise PhaseError(f"{what}: frames covered {out['frame_indices']}")
    for field in ("bboxes", "probs_temp_objectness"):
        for a in out[field]:
            if not np.all(np.isfinite(np.asarray(a, np.float64))):
                raise PhaseError(f"{what}: non-finite {field}")


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _model_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def _run_path(torch, gpu, model, cfg, tok, clips, t_total, label, need,
              decode_kwargs=None):
    """One main-path run: infer_clips_batched then
    ground_clip_with_caption, launch counts zeroed just before and read
    just after; every kernel in `need` must have launched."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.infer.sliding import (ground_clip_with_caption,
                                               infer_clips_batched)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    outs, ms_batched = _timed(torch, lambda: infer_clips_batched(
        model, cfg, tok, clips, max_new_tokens=64,
        decode_kwargs=decode_kwargs))
    ground, ms_ground = _timed(torch, lambda: ground_clip_with_caption(
        model, cfg, tok, clips[0]["frames_clip"], clips[0]["frames_sam"],
        clips[0]["original_size"], caption=CAPTION, use_objectness=True))
    launches = {k: v.launches for k, v in _kernels.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    say(3, f"{label}: infer_clips_batched (2 clips x {t_total} frames, 64 "
           f"new tokens) {ms_batched:.1f} ms; ground_clip_with_caption "
           f"{ms_ground:.1f} ms; kernel launches {launches}; peak "
           f"{peak / 2**30:.2f} GiB, weights "
           f"{_model_bytes(model) / 2**30:.2f} GiB on {gpu}")
    for i, out in enumerate(outs):
        _check_output(out, CLIP_KEYS, t_total, f"{label} clip {i}")
        say(3, f"{label} clip {i}: {len(out['phrases'])} phrases, caption "
               f"{out['text'][:80]!r}")
    _check_output(ground, GROUND_KEYS, t_total,
                  f"{label} ground_clip_with_caption")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise PhaseError(f"{label}: kernels never launched on the main "
                         f"path: {missing}")
    return launches


def _replay(torch, gpu, model, cfg, tok, clips, label, cache_dtype,
            encoders: bool):
    """Timed replay of the stages on the first call's inputs; returns the
    stage times and the greedy ids of the 64-step decode."""
    from grove_tpu_torch.infer.generate import greedy_decode
    from grove_tpu_torch.infer.sliding import center_prompts
    from grove_tpu_torch.models.llama import init_kv_caches
    dev, nf = "cuda", cfg.num_frames
    fc = torch.from_numpy(np.stack([c["frames_clip"][:nf] for c in clips])
                          ).to(dev)
    fs = torch.from_numpy(np.stack([c["frames_sam"][:nf] for c in clips])
                          ).to(dev)
    stages = {}
    with torch.inference_mode():
        (emb, _), t_clip = _timed(torch, lambda: model.encode_video(fc))
        img, t_sam = _timed(torch, lambda: model.encode_grounding_auto(fs))
        if encoders:
            stages.update(clip=t_clip, sam=t_sam)
        ids, starts, _ = center_prompts(cfg, tok, [None, None])
        ids_t = torch.from_numpy(ids).to(dev)
        caches = init_kv_caches(cfg.llama, 2, ids.shape[1] + 64,
                                dtype=cache_dtype, device=dev)
        _, stages["prefill"] = _timed(
            torch, lambda: model.prefill(ids_t, emb, starts, caches))
        (gen, hidden), ms_gen = _timed(torch, lambda: greedy_decode(
            model, ids_t, emb, starts, max_new_tokens=64,
            eos_id=cfg.tokens.eos, cache_dtype=cache_dtype,
            early_exit=False))
        stages["decode_64"] = ms_gen - stages["prefill"]
        det = torch.arange(cfg.max_phrases, device=dev)[None].expand(2, -1)
        if encoders:
            _, stages["ground"] = _timed(
                torch, lambda: model.ground(hidden, det, img))
        # a 32-token answer after the prompt, bucketed to 64 like
        # _finish_clip does
        pad = -(-(ids.shape[1] + 32) // 64) * 64 - ids.shape[1]
        batch = {"frames_clip": fc, "frames_sam": fs,
                 "input_ids": torch.nn.functional.pad(ids_t, (0, pad)),
                 "video_start": starts, "det_positions": det}
        _, stages["teacher_forced_2x8"] = _timed(
            torch, lambda: model.forward_boxes(batch))
    say(3, f"{label} stage ms (2 clips x 8 frames, replay): "
           + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
           + f"; decode {stages['decode_64'] / 64:.2f} ms/step on {gpu}")
    return stages, gen.cpu().numpy()


def phase_slice(torch, gpu):
    from grove_tpu.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.api import GroveForCausalLM

    t0 = time.perf_counter()
    lm = GroveForCausalLM.from_pretrained(None, "full", device="cuda",
                                          dtype=torch.bfloat16, seed=0)
    cfg, model = lm.cfg, lm.model
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    assert tok.token_id("[DET]") == cfg.tokens.det
    n_params = sum(p.numel() for p in model.parameters())
    say(3, f"bf16 model: {n_params / 1e9:.3f} B parameters built on "
           f"the card in {time.perf_counter() - t0:.1f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    t_total = 24
    clips = _synthetic_clips(cfg, 2, t_total, seed=1)
    quant = set(QUANT_KERNELS)
    bf16 = [k for k in _kernels.KERNELS if k not in quant]
    launches = _run_path(torch, gpu, model, cfg, tok, clips, t_total,
                         "bf16", bf16)
    _, gen_bf16 = _replay(torch, gpu, model, cfg, tok, clips, "bf16",
                          torch.bfloat16, encoders=True)

    t0 = time.perf_counter()
    lm = lm.quantize(bits=4)
    torch.cuda.synchronize()
    cfg, model = lm.cfg, lm.model
    say(3, f"quantize(bits=4) in place on the card in "
           f"{time.perf_counter() - t0:.1f} s: weights "
           f"{_model_bytes(model) / 2**30:.2f} GiB")
    int8_kv = {"cache_dtype": torch.int8}
    q_launches = _run_path(torch, gpu, model, cfg, tok, clips, t_total,
                           "int4 + int8 KV", list(_kernels.KERNELS),
                           decode_kwargs=int8_kv)
    launches.update({k: q_launches[k] for k in quant})
    _, gen_q = _replay(torch, gpu, model, cfg, tok, clips,
                       "int4 + int8 KV", torch.int8, encoders=False)
    same = int((gen_q == gen_bf16).sum())
    first = (int(np.argmax((gen_q != gen_bf16).any(0)))
             if same < gen_q.size else gen_q.shape[1])
    say(3, f"greedy tokens of the int4 + int8 KV replay equal to the bf16 "
           f"replay's: {same} of {gen_q.size} (identical prefix {first} "
           "steps; random weights, informational)")
    del model, lm
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4: fp32 parity kernels vs plain at GroveConfig.small()
# ---------------------------------------------------------------------------

def _parity_pass(torch, cfg, tok, clip, ap, cpu, gpu, label,
                 cache_dtype=None):
    """Teacher-forced boxes and objectness card vs CPU (within 1e-3), then
    the greedy-token agreement; returns the CPU's greedy ids."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.infer.generate import generate_grounded
    from grove_tpu_torch.infer.sliding import center_prompts

    def boxes_on(model, dev):
        batch = {
            "frames_clip": torch.from_numpy(clip["frames_clip"][None]).to(dev),
            "frames_sam": torch.from_numpy(clip["frames_sam"][None]).to(dev),
            "input_ids": torch.from_numpy(ap.input_ids[None].astype(
                np.int64)).to(dev),
            "video_start": np.asarray([int(ap.video_start)]),
            "det_positions": torch.from_numpy(ap.det_positions[None].astype(
                np.int64)).to(dev)}
        with torch.inference_mode():
            out = model.forward_boxes(batch)
        return (out["pred_boxes"].float().cpu().numpy(),
                out["objectness_logits"].float().cpu().numpy())

    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    (b_gpu, o_gpu), (b_cpu, o_cpu) = boxes_on(gpu, "cuda"), boxes_on(cpu,
                                                                        "cpu")
    used = [k for k, v in _kernels.KERNELS.items() if v.launches > before[k]]
    eb = float(np.abs(b_gpu - b_cpu).max())
    eo = float(np.abs(o_gpu - o_cpu).max())
    say(4, f"{label} teacher-forced: boxes max-abs diff {eb:.2e}, "
           f"objectness {eo:.2e} (card kernels {used} vs CPU plain)")
    if not (eb <= PARITY_TOL and eo <= PARITY_TOL):
        raise PhaseError(f"{label} teacher-forced parity {eb:.2e}/{eo:.2e} "
                         f"> {PARITY_TOL}")

    p_ids, starts, _ = center_prompts(cfg, tok, [None])
    gens = []
    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    for model in (gpu, cpu):
        dev = model.device
        g = generate_grounded(
            model, cfg, tok, p_ids, starts,
            torch.from_numpy(clip["frames_clip"][None]).to(dev),
            torch.from_numpy(clip["frames_sam"][None]).to(dev),
            max_new_tokens=64, early_exit=False, cache_dtype=cache_dtype)
        gens.append(g["generated_ids"][0])
    used = [k for k, v in _kernels.KERNELS.items() if v.launches > before[k]]
    agree = float(np.mean(gens[0] == gens[1]))
    first = int(np.argmax(gens[0] != gens[1])) if agree < 1 else 64
    say(4, f"{label} greedy tokens card vs CPU: {agree * 100:.1f}% of 64 "
           f"agree, identical prefix {first} (card kernels {used})")
    return p_ids, starts, gens[1]


def _int8_steps(torch, cfg, clip, model, p_ids, starts, tokens):
    """Hidden states of the prefill's last row and of len(tokens) decode
    steps fed `tokens`, over an int8 cache."""
    from grove_tpu_torch.models.llama import init_kv_caches
    dev = model.device
    ls = p_ids.shape[1]
    ids = torch.from_numpy(p_ids).to(dev)
    with torch.inference_mode():
        emb, _ = model.encode_video(
            torch.from_numpy(clip["frames_clip"][None]).to(dev))
        caches = init_kv_caches(cfg.llama, 1, ls + len(tokens),
                                dtype=torch.int8, device=dev)
        h, _, caches = model.prefill(ids, emb, starts, caches)
        out = [h[0, -1].float().cpu().numpy()]
        for i, t in enumerate(tokens):
            h, _, caches = model.decode_step(
                torch.tensor([[int(t)]], device=dev), ls + i, caches)
            out.append(h[0, 0].float().cpu().numpy())
    return out


def phase_parity(torch):
    from grove_tpu.config import GroveConfig
    from grove_tpu.text.mock_tokenizer import MockTokenizer
    from grove_tpu.text.packing import pack_text
    from grove_tpu.text.prompts import grounding_prompt, tokenize_with_video
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.ops.quant import quantize_llama_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GroveConfig.small()
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    cpu = init_grove_params(cfg, device="cpu", dtype=torch.float32, seed=2)
    gpu = copy.deepcopy(cpu).to("cuda")
    clip = _synthetic_clips(cfg, 1, cfg.num_frames, seed=3)[0]

    ids = tokenize_with_video(grounding_prompt(
        answer=f"<p> {CAPTION} </p> [DET]"), tok)
    spliced = len(ids) - 1 + cfg.num_video_tokens
    ap = pack_text(ids, None, tok, num_video_tokens=cfg.num_video_tokens,
                   max_spliced_len=-(-spliced // 64) * 64,
                   det_token_id=cfg.tokens.det, max_phrases=cfg.max_phrases,
                   pad_id=tok.pad_token_id, with_labels=False)
    _parity_pass(torch, cfg, tok, clip, ap, cpu, gpu,
                 "GroveConfig.small() fp32")

    # the same weights with the LLM quantized to int4, on both devices
    quantize_llama_(cpu, 4)
    gpu = copy.deepcopy(cpu).to("cuda")
    cfg = cpu.cfg
    p_ids, starts, cpu_ids = _parity_pass(
        torch, cfg, tok, clip, ap, cpu, gpu,
        "GroveConfig.small() fp32, int4 LLM + int8 KV", torch.int8)
    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    card = _int8_steps(torch, cfg, clip, gpu, p_ids, starts, cpu_ids[:16])
    used = [k for k, v in _kernels.KERNELS.items() if v.launches > before[k]]
    host = _int8_steps(torch, cfg, clip, cpu, p_ids, starts, cpu_ids[:16])
    rels = [float(np.abs(g - c).max() / np.abs(c).max())
            for g, c in zip(card, host)]
    say(4, f"int4 + int8 KV, the CPU's greedy ids through prefill + 16 "
           f"decode steps: hidden-state max-abs diff of each step relative "
           f"to its max-abs, worst {max(rels):.2e}, last {rels[-1]:.2e} "
           f"(card kernels {used})")
    if not max(rels) <= STEP_TOL:
        raise PhaseError(f"int8-cache decode steps card vs CPU: "
                         f"{max(rels):.2e} > {STEP_TOL} of max-abs")


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        if not (ROOT / "grove_tpu_torch" / "__init__.py").is_file():
            raise PhaseError(f"grove_tpu_torch not found beside {__file__}")
        sys.path.insert(0, str(ROOT))
        import torch
        gpu = phase_device(torch)
        torch.backends.cuda.matmul.allow_tf32 = False
        phase_build()
        rows = phase_kernels(torch, gpu)
        launches = phase_slice(torch, gpu)
        phase_parity(torch)
    except Exception:                       # report, then fail the run
        traceback.print_exc()
        print("chip_smoke FAILED", file=sys.stderr, flush=True)
        return 1

    from grove_tpu_torch import _kernels
    kernels = []
    for name, k in _kernels.KERNELS.items():
        row = {"name": name, "route": "cuda", "source": k.source,
               "replaces": k.replaces, "launches": launches[name]}
        row.update(rows[name])
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
