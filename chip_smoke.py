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
     times of both. One fp32 K1 case and one fp32 K1q case carry an
     all-underflow row, which must come out as exact zeros (the TPU
     kernel's EXP2_SHIFT contract). The int8 outputs are held in LSBs: K8a
     and K8b |diff| <= 1 on at most 0.1% of the elements (K8b's residual
     sum bit-equal), K1q <= 2 LSB on at most 0.1% in bf16 and <= 1 LSB on
     at most 0.01% in fp32.
     K6, K7a, K8a and K8b take microseconds and read inputs that are cold
     in the model (every layer has its own cache, weights or
     activations), so they are timed as CUDA-graph replays over copies of
     more than 64 MiB, beyond the 50 MB L2 (eager calls between events
     would time the host's launch overhead). K7a has three full-width
     shapes (the q/k/v/o, gate/up and down projections of a decode step),
     K8a two (the CLIP and SAM norm sites); their JSON times are the sums;
  3  slice: GroveConfig() (CLIP ViT-L/336, SAM ViT-H/512, LLaMA-7B) built
     on the card from a seed (GroveForCausalLM.from_pretrained), first in
     bf16, then quantized in place (quantize(bits=4): int4 projections,
     int8 lm_head) and run with the int8 KV cache, then with the towers
     W8A8 too (ops.quant.quantize_vision_ in place, GroveForCausalLM.
     calibrate on one synthetic clip: static activation scales). Each run
     drives infer_clips_batched on 2 synthetic 24-frame clips (64 new
     tokens) and ground_clip_with_caption with the launch counts zeroed
     just before and read just after; outputs must carry the JAX package's
     keys and be finite; the bf16 run must launch K1-K4, the int4 run
     K1-K7a, the W8A8-static run K2-K7a, K8b and K1q. Then a timed replay
     of the stages, peak device memory and weight bytes of each, and how
     many greedy tokens the quantized replays share with the bf16 one;
  4  parity: GroveConfig.small() in fp32, one set of weights, on the card
     with the kernels and on the CPU with the plain versions (TF32 off):
     teacher-forced boxes and objectness within 1e-3, greedy token
     agreement; then the same with the LLM quantized to int4: boxes within
     1e-3, and the CPU's greedy ids fed to both through prefill and 16
     decode steps over an int8 cache, each step's hidden states within
     1e-2 of their max-abs (one int8 LSB of K/V may flip between the two);
     then the towers W8A8-static with quant_ln_kernel=True, calibrated
     once on the CPU and deep-copied to the card: boxes and objectness
     within 1e-2, and the run must launch K8a, K8b and K1q. Whole-tower
     outputs (video tokens, SAM embeddings) are printed beside what inputs
     moved by 1e-6 (relative) do to them on the CPU, for information only:
     an int8 LSB that flips at one site cascades through the later ones.
     So every quant site of the card's towers (each LayerNormQuant, i.e.
     K8a, K8b or the chain; each SamAttention, i.e. K1q or K2 and a static
     quantize; each Int8Linear and Int8Conv3d) is then fed the CPU's input
     to that site: int8 activations <= 1 LSB on at most 0.1% of a site's,
     float outputs within 1e-5 of the CPU's max-abs.

The line before the last is a JSON object with each kernel's measurements
(`launches`: K1-K4 from the bf16 run of phase 3, K5-K7a from the int4 one,
K8b and K1q from the W8A8-static one, K8a from phase 4's W8A8-static
model path); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
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
W8A8_TOL = 1e-2          # phase 4 W8A8-static towers: boxes / objectness
SITE_TOL = 1e-5          # phase 4 float outputs of a quant site, of max-abs
LSB_SHARE = 1e-3         # share of int8 outputs allowed off (K8a, K8b, K1q)
FP32_LSB_SHARE = 1e-4    # the same for K1q in fp32
COLD_BYTES = 64 * 2**20  # inputs cycled past the L2 when timing cold kernels
QUANT_KERNELS = ("prefill_attention", "int8_decode_attention", "int4_matmul")
W8A8_KERNELS = ("add_layernorm_quant", "sam_window_attention_q8")
LN_KERNEL = "layernorm_quant"             # phase 4's quant_ln_kernel path
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
                                     flash_backward, fused_ln, int4_matmul,
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

    def k1q_inputs(gen, dtype, shape):
        qkv, rel, hw, heads = k1_inputs(gen, dtype, shape)
        # an act scale that puts the outputs across the int8 range
        inv = torch.full((1,), 64.0, device="cuda")
        return (qkv, rel, hw, heads, inv)

    def k1q(qkv, rel, hw, heads, inv):
        return sam_attention.grouped_window_attention_relpos_v3(
            qkv, rel, hw, heads, inv_scale=inv)

    def k1q_plain(qkv, rel, hw, heads, inv):
        return sam_attention.grouped_window_attention_relpos_v3_q8_torch(
            qkv, rel, inv, hw, heads)

    def ln_inputs(gen, dtype, shape, add=False):
        rows, c = shape
        x = (randn(gen, (rows, c), torch.float32) * 2 + 0.3).to(dtype)
        s = 0.03                  # saturates the largest few outputs
        gs = uniform(gen, (c,), 0.5, 1.5) / s
        bs = 0.1 * randn(gen, (c,), torch.float32) / s
        if add:
            return (x, randn(gen, (rows, c), dtype), gs, bs, 1e-6)
        return (x, gs, bs, 1e-5)

    # full-width shapes of the main paths: 16 frames (2 clips x 8) of SAM
    # (9 windows each) and CLIP, 2 teacher-forced windows of LLaMA-7B, and
    # the int8-cache prefill (2 x 640 tokens) and decode step of the
    # quantized run (M = 2 rows, a 768-slot cache)
    def case(fn, plain, make, full, small, cold=False, int8=None):
        """int8: (LSB, share) limits of an int8 output, full bf16 and small
        fp32, instead of the float error limits."""
        return dict(fn=fn, plain=plain, make=make, full=full, small=small,
                    cold=cold, int8=int8)

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
        # 16 frames of CLIP (577 tokens, C 1024) and of SAM (32 x 32, 1280)
        "layernorm_quant": case(
            fused_ln.layernorm_quant_folded,
            fused_ln.layernorm_quant_folded_torch, ln_inputs,
            [(16 * 577, 1024), (16 * 1024, 1280)],
            [(300, 256), (37, 384), (5, 2048)], cold=True,
            int8={"full": (1, LSB_SHARE), "small": (1, LSB_SHARE)}),
        "add_layernorm_quant": case(
            fused_ln.add_layernorm_quant_folded,
            fused_ln.add_layernorm_quant_folded_torch,
            lambda g, d, sh: ln_inputs(g, d, sh, add=True),
            [(16 * 1024, 1280)], [(300, 256), (37, 512)], cold=True,
            int8={"full": (1, LSB_SHARE), "small": (1, LSB_SHARE)}),
        "sam_window_attention_q8": case(
            k1q, k1q_plain, k1q_inputs, [(144, 14, 16, 80)],
            [(4, 8, 6, 64), (3, 2, 4, 8), (2, 4, 2, 64, "underflow")],
            int8={"full": (2, LSB_SHARE), "small": (1, FP32_LSB_SHARE)}),
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


def _int8_diff(got, want):
    """(max |diff| in LSBs, share of elements that differ) of int8
    outputs; a float output (K8b's residual sum) must be bit-equal, so it
    counts its own max-abs difference."""
    if not got.dtype.is_floating_point:
        d = (got.int() - want.int()).abs()
        return int(d.max()), float((d > 0).float().mean())
    return _max_err(got, want), 0.0


def _check_int8(name, label, got, want, limits):
    """Raise unless every output of an int8 kernel is within `limits`
    (LSB, share); return the worst (LSB, share)."""
    lsb_lim, share_lim = limits
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = (0, 0.0)
    for g, w in zip(got, want):
        lsb, share = _int8_diff(g, w)
        if g.dtype.is_floating_point:
            if lsb != 0:
                raise PhaseError(f"{name} {label}: residual sum differs "
                                 f"from the plain twin's by {lsb:.3e}")
            continue
        if not (lsb <= lsb_lim and share <= share_lim):
            raise PhaseError(f"{name} {label}: int8 outputs {lsb} LSB apart "
                             f"on {share:.3e} of them (limit {lsb_lim} LSB "
                             f"on {share_lim})")
        worst = max(worst, (lsb, share))
    return worst


def _nbytes(torch, args):
    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


def _check_full(name, full, got, want):
    """Every float output of a full-width bf16 call (flash_forward_lse:
    out and LSE) within FULL_TOL of its own max-abs; returns
    [(max-abs error, relative error)]."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    out = []
    for g, w in zip(got, want):
        err = _max_err(g, w)
        scale = float(w.float().abs().max())
        if not (np.isfinite(err) and err <= FULL_TOL * scale):
            raise PhaseError(f"{name} bf16 {full}: max-abs error "
                             f"{err:.3e} > {FULL_TOL} x {scale:.3e}")
        out.append((err, err / scale))
    return out


def phase_kernels(torch, gpu):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, c in _cases(torch).items():
        fn, plain, make, int8 = c["fn"], c["plain"], c["make"], c["int8"]
        for shape in c["small"]:
            args = make(gen, torch.float32, shape)
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            if int8:
                lsb, share = _check_int8(name, f"fp32 {shape}", got, want,
                                         int8["small"])
                note = f"{lsb} LSB on {share:.2e} of the int8 outputs"
            else:
                err = _max_err(got, want)
                if not err <= FP32_TOL:
                    raise PhaseError(f"{name} fp32 {shape}: max-abs error "
                                     f"{err:.3e} > {FP32_TOL}")
                note = f"max-abs error {err:.3e}"
            if "underflow" in shape:
                row_k = float(got[0, 0].abs().max())
                row_p = float(want[0, 0].abs().max())
                if row_k != 0.0 or row_p != 0.0:
                    raise PhaseError(f"{name}: all-underflow row gives "
                                     f"{row_k:.3e} (kernel), {row_p:.3e} "
                                     "(plain), not 0")
                note += "; the all-underflow row is exactly 0 in both"
            say(2, f"{name} fp32 {shape}: {note}")
        errs, ms, plain_ms = [], 0.0, 0.0
        for full in c["full"]:
            args = make(gen, torch.bfloat16, full)
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            if int8:
                lsb, share = _check_int8(name, f"bf16 {full}", got, want,
                                         int8["full"])
                new = [(float(lsb), share)]
                what = f"int8 outputs {lsb} LSB apart on {share:.2e} of them"
            else:
                new = _check_full(name, full, got, want)
                what = (f"max-abs error "
                        f"{', '.join(f'{e:.3e}' for e, _ in new)} (relative "
                        f"{', '.join(f'{r:.2e}' for _, r in new)})")
            errs += new
            del got, want
            sets, timer, how = [args], _time_ms, ""
            if c["cold"]:
                copies = -(-COLD_BYTES // _nbytes(torch, args))
                sets += [make(gen, torch.bfloat16, full)
                         for _ in range(copies - 1)]
                timer = _graph_ms
                how = f" (CUDA graph over {len(sets)} cold copies)"
            t, tp = timer(torch, fn, sets), timer(torch, plain, sets)
            say(2, f"{name} bf16 {full}: {what}; kernel {t:.4f} ms, plain "
                   f"{tp:.4f} ms{how} on {gpu}")
            ms += t
            plain_ms += tp
            del args, sets
            torch.cuda.empty_cache()
        # int8 kernels: the error in LSBs and the share of outputs off
        second = "lsb_share" if int8 else "rel_err"
        rows[name] = {"max_abs_err": max(e for e, _ in errs),
                      second: max(r for _, r in errs), "ms": ms,
                      "plain_ms": plain_ms}
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
    from grove_tpu_torch.ops.quant import quantize_vision_

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
    bf16 = [k for k in _kernels.KERNELS
            if k not in quant | set(W8A8_KERNELS) | {LN_KERNEL}]
    launches = _run_path(torch, gpu, model, cfg, tok, clips, t_total,
                         "bf16", bf16)
    st_bf16, gen_bf16 = _replay(torch, gpu, model, cfg, tok, clips, "bf16",
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
                           "int4 + int8 KV", bf16 + list(quant),
                           decode_kwargs=int8_kv)
    launches.update({k: q_launches[k] for k in quant})
    _, gen_q = _replay(torch, gpu, model, cfg, tok, clips,
                       "int4 + int8 KV", torch.int8, encoders=False)
    _same_tokens(gen_q, gen_bf16, "int4 + int8 KV")

    # the towers W8A8 too, calibrated on the first 8 frames of one clip
    t0 = time.perf_counter()
    quantize_vision_(model)
    nf = cfg.num_frames
    lm.calibrate(clips[0]["frames_clip"][None, :nf],
                 clips[0]["frames_sam"][None, :nf])
    torch.cuda.synchronize()
    cfg = lm.cfg
    label = "int4 + int8 KV + W8A8-static towers"
    say(3, f"towers quantized in place and calibrated on the card in "
           f"{time.perf_counter() - t0:.1f} s: weights "
           f"{_model_bytes(model) / 2**30:.2f} GiB")
    need = [k for k in _kernels.KERNELS
            if k not in ("sam_window_attention", LN_KERNEL)]
    w_launches = _run_path(torch, gpu, model, cfg, tok, clips, t_total,
                           label, need, decode_kwargs=int8_kv)
    launches.update({k: w_launches[k] for k in W8A8_KERNELS})
    st_w, gen_w = _replay(torch, gpu, model, cfg, tok, clips, label,
                          torch.int8, encoders=True)
    say(3, f"encoder stages, W8A8-static vs bf16 (2 clips x 8 frames): "
           f"CLIP {st_w['clip']:.1f} vs {st_bf16['clip']:.1f} ms, SAM "
           f"{st_w['sam']:.1f} vs {st_bf16['sam']:.1f} ms on {gpu}")
    _same_tokens(gen_w, gen_bf16, label)
    del model, lm
    torch.cuda.empty_cache()
    return launches


def _same_tokens(gen, gen_bf16, label):
    same = int((gen == gen_bf16).sum())
    first = (int(np.argmax((gen != gen_bf16).any(0)))
             if same < gen.size else gen.shape[1])
    say(3, f"greedy tokens of the {label} replay equal to the bf16 "
           f"replay's: {same} of {gen.size} (identical prefix {first} "
           "steps; random weights, informational)")


# ---------------------------------------------------------------------------
# phase 4: fp32 parity kernels vs plain at GroveConfig.small()
# ---------------------------------------------------------------------------

def _tower_outputs(torch, model, clip, noise=0.0):
    """(video tokens, SAM embeddings) of one clip on the model's device,
    from normalized frames scaled by (1 + noise * N(0, 1))."""
    dev = model.device
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        out = []
        for key, encode in (("frames_clip", model.encode_video),
                            ("frames_sam", model.encode_grounding)):
            frames = torch.from_numpy(clip[key][None]).to(dev)
            x = (model._norm_clip(frames) if key == "frames_clip"
                 else model._norm_sam(frames))
            if noise:
                x = x * (1 + noise * torch.randn(x.shape, generator=gen)
                         .to(dev))
            y = encode(x)
            out.append((y[0] if isinstance(y, tuple) else y).float().cpu()
                       .numpy())
    return out


def _rel_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _quant_sites(model):
    """name -> module of every W8A8 quant site of the towers: each
    LayerNormQuant (K8a, K8b or the torch chain), Int8Linear and
    Int8Conv3d, and each SamAttention of a W8A8 tower (K1q, or K2 and a
    static quantize, then proj's int8 input)."""
    from grove_tpu_torch.models.layers import (Int8Conv3d, Int8Linear,
                                               LayerNormQuant)
    from grove_tpu_torch.models.sam_encoder import SamAttention
    from grove_tpu_torch.ops.quant import vision_towers
    kinds = (LayerNormQuant, Int8Linear, Int8Conv3d, SamAttention)
    return {f"{t}.{n}": m for t, tower in vision_towers(model).items()
            for n, m in tower.named_modules() if isinstance(m, kinds)}


def _record_sites(model):
    """Forward hooks that keep every call's (inputs, outputs) of each quant
    site; returns ({name: [(args, out)]}, hook handles)."""
    calls, handles = {}, []
    for name, mod in _quant_sites(model).items():
        def hook(mod, args, out, name=name):
            calls.setdefault(name, []).append((args, out))
        handles.append(mod.register_forward_hook(hook))
    return calls, handles


def _int8_out(torch, name, out, calls, i):
    """The int8 activation a site hands on: a norm's int8 output; for a
    SamAttention its proj's int8 input in the same (i-th) call."""
    if name + ".proj" in calls:
        return calls[name + ".proj"][i][0][0]
    return next(t for t in _tensors(out) if t.dtype == torch.int8)


def _site_parity(torch, cpu, gpu, clip, label):
    """Every quant site of the card's towers fed the CPU's input to that
    site, so no int8 flip of an earlier site reaches it: its int8 output
    at most 1 LSB off on at most LSB_SHARE of the elements (as phase 2
    holds K8a, K8b and K1q), its float outputs (a norm's residual sum, a
    linear's or conv's epilogue) within SITE_TOL of the CPU's max-abs."""
    from grove_tpu_torch.models.layers import LayerNormQuant
    from grove_tpu_torch.models.sam_encoder import SamAttention
    host, handles = _record_sites(cpu)
    try:
        _tower_outputs(torch, cpu, clip)
    finally:
        for h in handles:
            h.remove()
    sites = _quant_sites(gpu)
    card, handles = _record_sites(gpu)
    worst = {"int8": (0, 0.0), "float": 0.0}
    flipped = elems = 0
    try:
        with torch.inference_mode():
            for name, host_calls in host.items():
                mod = sites[name]
                for i, (args, want) in enumerate(host_calls):
                    got = mod(*(a.to(gpu.device)
                                if isinstance(a, torch.Tensor) else a
                                for a in args))
                    if isinstance(mod, (LayerNormQuant, SamAttention)):
                        g = _int8_out(torch, name, got, card,
                                      len(card.get(name + ".proj", [])) - 1)
                        c = _int8_out(torch, name, want, host, i)
                        d = (g.cpu().int() - c.int()).abs()
                        lsb, n = int(d.max()), int((d > 0).sum())
                        if not (lsb <= 1 and n <= LSB_SHARE * d.numel()):
                            raise PhaseError(
                                f"{label}: {name} fed the CPU's input: int8 "
                                f"{lsb} LSB apart on {n} of {d.numel()} "
                                f"(limit 1 LSB on {LSB_SHARE})")
                        worst["int8"] = max(worst["int8"],
                                            (lsb, n / d.numel()))
                        flipped, elems = flipped + n, elems + d.numel()
                    if isinstance(mod, SamAttention):
                        continue        # proj is a site of its own
                    for g, c in zip(_tensors(got), _tensors(want)):
                        if c.dtype == torch.int8 or c.dim() == 0:
                            continue    # the int8 output, the act scale
                        err = _rel_max(g.float().cpu().numpy(),
                                       c.float().numpy())
                        if not err <= SITE_TOL:
                            raise PhaseError(
                                f"{label}: {name} fed the CPU's input: "
                                f"output {err:.2e} of max-abs from the "
                                f"CPU's > {SITE_TOL}")
                        worst["float"] = max(worst["float"], err)
    finally:
        for h in handles:
            h.remove()
    lsb, share = worst["int8"]
    say(4, f"{label}, each of {len(host)} quant sites fed the CPU's input: "
           f"int8 activations (norms, K1q / K2 -> proj) at most {lsb} LSB "
           f"apart on at most {share:.2e} of a site's, {flipped} of "
           f"{elems} in all; float outputs within {worst['float']:.2e} of "
           "max-abs")


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


def _boxes_on(torch, model, clip, ap):
    """Teacher-forced boxes and objectness of one clip on the model's
    device, as numpy."""
    dev = model.device
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


def _boxes_parity(torch, clip, ap, cpu, gpu, label, tol):
    """Teacher-forced boxes and objectness card vs CPU within `tol`;
    returns the kernels the card's pass launched."""
    from grove_tpu_torch import _kernels
    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    (b_gpu, o_gpu) = _boxes_on(torch, gpu, clip, ap)
    used = [k for k, v in _kernels.KERNELS.items() if v.launches > before[k]]
    b_cpu, o_cpu = _boxes_on(torch, cpu, clip, ap)
    eb = float(np.abs(b_gpu - b_cpu).max())
    eo = float(np.abs(o_gpu - o_cpu).max())
    say(4, f"{label} teacher-forced: boxes max-abs diff {eb:.2e}, "
           f"objectness {eo:.2e} (card kernels {used} vs CPU plain)")
    if not (eb <= tol and eo <= tol):
        raise PhaseError(f"{label} teacher-forced parity {eb:.2e}/{eo:.2e} "
                         f"> {tol}")
    return used


def _parity_pass(torch, cfg, tok, clip, ap, cpu, gpu, label,
                 cache_dtype=None):
    """Teacher-forced boxes and objectness card vs CPU (within 1e-3), then
    the greedy-token agreement; returns the CPU's greedy ids."""
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.infer.generate import generate_grounded
    from grove_tpu_torch.infer.sliding import center_prompts

    _boxes_parity(torch, clip, ap, cpu, gpu, label, PARITY_TOL)

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
    from grove_tpu_torch.ops.quant import (calibrate_vision_, quantize_llama_,
                                           quantize_vision_)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # quant_ln_kernel: once the towers are W8A8, every norm site without a
    # residual branch takes K8a (the flag does nothing to float towers)
    cfg = GroveConfig.small()
    cfg = dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, quant_ln_kernel=True),
        sam_enc=dataclasses.replace(cfg.sam_enc, quant_ln_kernel=True))
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

    # the towers W8A8-static, calibrated once on the CPU
    quantize_vision_(cpu)
    calibrate_vision_(cpu, clip["frames_clip"][None], clip["frames_sam"][None])
    gpu = copy.deepcopy(cpu).to("cuda")
    label = "GroveConfig.small() fp32, W8A8-static towers (quant_ln_kernel)"
    _kernels.reset_launch_counts()
    _boxes_parity(torch, clip, ap, cpu, gpu, label, W8A8_TOL)
    outs = [_tower_outputs(torch, gpu, clip)]
    launches = {k: v.launches for k, v in _kernels.KERNELS.items()}
    missing = [k for k in (LN_KERNEL, *W8A8_KERNELS) if launches[k] <= 0]
    if missing:
        raise PhaseError(f"{label}: kernels never launched: {missing}")
    outs.append(_tower_outputs(torch, cpu, clip))
    # the CPU's own spread: the same towers on inputs moved by 1e-6
    outs.append(_tower_outputs(torch, cpu, clip, noise=1e-6))
    names = ("video tokens", "SAM embeddings")
    for n, g, c in zip(names, outs[0], outs[1]):
        if g.shape != c.shape or not np.all(np.isfinite(g)):
            raise PhaseError(f"{label}: {n} {g.shape} on the card, "
                             f"{c.shape} on the CPU, or not finite")
    # information only: one int8 LSB that flips at a site moves its output
    # by 1/127 of the site's range and the flips cascade through the
    # blocks, so whole towers differ as much as float noise moves them;
    # _site_parity holds each quant site on its own
    say(4, f"{label}: whole towers card vs CPU relative to max-abs: "
           + ", ".join(f"{n} {_rel_max(g, c):.2e}"
                       for n, g, c in zip(names, outs[0], outs[1]))
           + "; the CPU against itself on inputs moved by 1e-6: "
           + ", ".join(f"{n} {_rel_max(g, c):.2e}"
                       for n, g, c in zip(names, outs[2], outs[1]))
           + f" (informational); kernel launches {launches}")
    _site_parity(torch, cpu, gpu, clip, label)
    return launches


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
        launches[LN_KERNEL] = phase_parity(torch)[LN_KERNEL]
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
