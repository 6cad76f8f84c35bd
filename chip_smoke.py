#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (grove_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # one card, no arguments

Phases, each printing its own line; any failure exits non-zero:
  0  device: requires CUDA (there is no CPU path) and prints the card's
     name and power limit as nvidia-smi reports them;
  1  build: compiles grove_tpu_torch/csrc with nvcc for sm_90a;
  2  kernels: each hand-written kernel against its plain torch twin on the
     card, at the full-width shapes of the main path in bf16 (max-abs error
     <= 2e-2 of the output's max-abs, for flash_forward_lse of the LSE's
     too) and at small fp32 shapes (<= 1e-4), with median CUDA-event times
     of both;
  3  slice: GroveConfig() (CLIP ViT-L/336, SAM ViT-H/512, LLaMA-7B) in bf16,
     built on the card from a seed, runs infer_clips_batched on 2 synthetic
     24-frame clips (64 new tokens) and ground_clip_with_caption; outputs
     must carry the JAX package's keys and be finite, and each kernel's
     launch count over that run must be > 0; then a timed replay of the
     stages and the peak device memory;
  4  parity: GroveConfig.small() in fp32, one set of weights, on the card
     with the kernels and on the CPU with the plain versions (TF32 off):
     teacher-forced boxes and objectness within 1e-3; prints the greedy
     token agreement.

The line before the last is a JSON object with each kernel's measurements;
the last line is {"ok": true, "device": {...}}.
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
    """name -> (kernel fn, plain fn, make_inputs(dtype, full: bool))."""
    from grove_tpu_torch.ops import attention, flash_backward, sam_attention

    def randn(gen, shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    def k1_inputs(gen, dtype, shape):
        nw, win, heads, d = shape
        s = win * win
        qkv = randn(gen, (nw, s, 3 * heads * d), dtype)
        rel = randn(gen, (nw, s, heads * 2 * win), dtype)
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

    # full-width shapes of the main path: 16 frames (2 clips x 8) of SAM
    # (9 windows each) and CLIP, and 2 teacher-forced windows of LLaMA-7B
    return {
        "sam_window_attention": (
            sam_attention.grouped_window_attention_relpos_v3,
            sam_attention.grouped_window_attention_relpos_v3_torch,
            k1_inputs, (144, 14, 16, 80), [(4, 8, 6, 64), (3, 2, 4, 8)]),
        "sam_global_attention": (
            sam_attention.grouped_window_attention_relpos,
            sam_attention.grouped_window_attention_relpos_torch,
            k2_inputs, (16, 32, 16, 80), [(2, 16, 6, 64), (2, 4, 4, 8)]),
        "grouped_plain_attention": (
            attention.grouped_plain_attention,
            attention.grouped_plain_attention_torch,
            qkv_inputs, (16, 577, 16, 64),
            [(2, 257, 8, 64), (2, 5, 4, 8)]),
        "flash_forward_lse": (
            k4, k4_plain, qkv_inputs, (2, 704, 32, 128),
            [(2, 192, 12, 64), (1, 45, 4, 8)]),
    }


def _time_ms(torch, fn, args, reps=10):
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_err(got, want):
    if isinstance(got, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def phase_kernels(torch, gpu):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, (fn, plain, make, full, smalls) in _cases(torch).items():
        for shape in smalls:
            args = make(gen, torch.float32, shape)
            err = _max_err(fn(*args), plain(*args))
            torch.cuda.synchronize()
            if not err <= FP32_TOL:
                raise PhaseError(f"{name} fp32 {shape}: max-abs error "
                                 f"{err:.3e} > {FP32_TOL}")
            say(2, f"{name} fp32 {shape}: max-abs error {err:.3e}")
        args = make(gen, torch.bfloat16, full)
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        # every output (flash_forward_lse: out and LSE), each relative to
        # its own max-abs
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs, rels = [], []
        for g, w in zip(got, want):
            err = _max_err(g, w)
            scale = float(w.float().abs().max())
            if not (np.isfinite(err) and err <= FULL_TOL * scale):
                raise PhaseError(f"{name} bf16 {full}: max-abs error "
                                 f"{err:.3e} > {FULL_TOL} x {scale:.3e}")
            errs.append(err)
            rels.append(err / scale)
        del got, want
        ms = _time_ms(torch, fn, args)
        plain_ms = _time_ms(torch, plain, args)
        say(2, f"{name} bf16 {full}: max-abs error "
               f"{', '.join(f'{e:.3e}' for e in errs)} (relative "
               f"{', '.join(f'{r:.2e}' for r in rels)}); kernel {ms:.3f} "
               f"ms, plain {plain_ms:.3f} ms on {gpu}")
        rows[name] = {"max_abs_err": max(errs), "rel_err": max(rels),
                      "ms": ms, "plain_ms": plain_ms}
        del args
        torch.cuda.empty_cache()
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


def phase_slice(torch, gpu):
    from grove_tpu.config import GroveConfig
    from grove_tpu.text.mock_tokenizer import MockTokenizer
    from grove_tpu_torch import _kernels
    from grove_tpu_torch.infer.generate import greedy_decode
    from grove_tpu_torch.infer.sliding import (center_prompts,
                                               ground_clip_with_caption,
                                               infer_clips_batched)
    from grove_tpu_torch.models.grove import init_grove_params
    from grove_tpu_torch.models.llama import init_kv_caches

    cfg, dev = GroveConfig(), "cuda"
    tok = MockTokenizer(base_vocab_size=cfg.llama.vocab_size)
    assert tok.token_id("[DET]") == cfg.tokens.det
    t0 = time.perf_counter()
    model = init_grove_params(cfg, device=dev, dtype=torch.bfloat16,
                              seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    say(3, f"bf16 model: {n_params / 1e9:.3f} B parameters built on "
           f"the card in {time.perf_counter() - t0:.1f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    t_total = 24
    clips = _synthetic_clips(cfg, 2, t_total, seed=1)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    outs, ms_batched = _timed(torch, lambda: infer_clips_batched(
        model, cfg, tok, clips, max_new_tokens=64))
    ground, ms_ground = _timed(torch, lambda: ground_clip_with_caption(
        model, cfg, tok, clips[0]["frames_clip"], clips[0]["frames_sam"],
        clips[0]["original_size"], caption=CAPTION, use_objectness=True))
    launches = {k: v.launches for k, v in _kernels.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    say(3, f"infer_clips_batched (2 clips x {t_total} frames, 64 new "
           f"tokens) {ms_batched:.1f} ms; ground_clip_with_caption "
           f"{ms_ground:.1f} ms; kernel launches {launches}; peak "
           f"{peak / 2**30:.2f} GiB on {gpu}")
    for i, out in enumerate(outs):
        _check_output(out, CLIP_KEYS, t_total, f"clip {i}")
        say(3, f"clip {i}: {len(out['phrases'])} phrases, caption "
               f"{out['text'][:80]!r}")
    _check_output(ground, GROUND_KEYS, t_total, "ground_clip_with_caption")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise PhaseError(f"kernels never launched on the main path: "
                         f"{missing}")

    # timed replay of the stages on the first call's inputs
    nf = cfg.num_frames
    fc = torch.from_numpy(np.stack([c["frames_clip"][:nf] for c in clips])
                          ).to(dev)
    fs = torch.from_numpy(np.stack([c["frames_sam"][:nf] for c in clips])
                          ).to(dev)
    stages = {}
    with torch.inference_mode():
        (emb, _), stages["clip"] = _timed(torch,
                                          lambda: model.encode_video(fc))
        img, stages["sam"] = _timed(
            torch, lambda: model.encode_grounding_auto(fs))
        ids, starts, _ = center_prompts(cfg, tok, [None, None])
        ids_t = torch.from_numpy(ids).to(dev)
        caches = init_kv_caches(cfg.llama, 2, ids.shape[1] + 64,
                                dtype=torch.bfloat16, device=dev)
        _, stages["prefill"] = _timed(
            torch, lambda: model.prefill(ids_t, emb, starts, caches))
        (gen, hidden), ms_gen = _timed(torch, lambda: greedy_decode(
            model, ids_t, emb, starts, max_new_tokens=64,
            eos_id=cfg.tokens.eos, early_exit=False))
        stages["decode_64"] = ms_gen - stages["prefill"]
        det = torch.arange(cfg.max_phrases, device=dev)[None].expand(2, -1)
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
    say(3, "stage ms (2 clips x 8 frames, replay): "
           + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
           + f"; decode {stages['decode_64'] / 64:.2f} ms/step on {gpu}")
    del model
    torch.cuda.empty_cache()
    return launches, stages


# ---------------------------------------------------------------------------
# phase 4: fp32 parity kernels vs plain at GroveConfig.small()
# ---------------------------------------------------------------------------

def phase_parity(torch):
    from grove_tpu.config import GroveConfig
    from grove_tpu.text.mock_tokenizer import MockTokenizer
    from grove_tpu.text.packing import pack_text
    from grove_tpu.text.prompts import grounding_prompt, tokenize_with_video
    from grove_tpu_torch.infer.generate import generate_grounded
    from grove_tpu_torch.infer.sliding import center_prompts
    from grove_tpu_torch.models.grove import init_grove_params

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

    from grove_tpu_torch import _kernels
    before = {k: v.launches for k, v in _kernels.KERNELS.items()}
    (b_gpu, o_gpu), (b_cpu, o_cpu) = boxes_on(gpu, "cuda"), boxes_on(cpu,
                                                                        "cpu")
    used = [k for k, v in _kernels.KERNELS.items() if v.launches > before[k]]
    eb = float(np.abs(b_gpu - b_cpu).max())
    eo = float(np.abs(o_gpu - o_cpu).max())
    say(4, f"GroveConfig.small() fp32 teacher-forced: boxes max-abs diff "
           f"{eb:.2e}, objectness {eo:.2e} (card kernels {used} vs CPU "
           f"plain)")
    if not (eb <= PARITY_TOL and eo <= PARITY_TOL):
        raise PhaseError(f"teacher-forced parity {eb:.2e}/{eo:.2e} > "
                         f"{PARITY_TOL}")

    p_ids, starts, _ = center_prompts(cfg, tok, [None])
    gens = []
    for model in (gpu, cpu):
        dev = model.device
        g = generate_grounded(
            model, cfg, tok, p_ids, starts,
            torch.from_numpy(clip["frames_clip"][None]).to(dev),
            torch.from_numpy(clip["frames_sam"][None]).to(dev),
            max_new_tokens=64, early_exit=False)
        gens.append(g["generated_ids"][0])
    agree = float(np.mean(gens[0] == gens[1]))
    first = int(np.argmax(gens[0] != gens[1])) if agree < 1 else 64
    say(4, f"greedy tokens card vs CPU: {agree * 100:.1f}% of 64 agree, "
           f"identical prefix {first}")


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
        launches, _ = phase_slice(torch, gpu)
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
