"""Where the W8A8 vision towers spend their device time, on one NVIDIA GPU.

    python3 -m grove_tpu_torch.profile_towers      # one card, no arguments

1. `torch._int_mm` at every int8 GEMM shape of the W8A8 towers for 2 clips
   x 8 frames (CLIP: 9232 tokens, adapter taps 9216 rows; SAM: 28224
   windowed tokens, 16384 global and adapter rows), with the second operand
   row-major (the JAX (K, N) layout as stored) and column-major (the same
   values, as the port stores `kernel_q`), beside a bf16 matmul of the same
   shape: median CUDA-event ms and TOP/s (TF/s for bf16).
2. `torch.profiler` over the towers of `GroveConfig()` built from a seed,
   2 clips x 8 frames, first bf16, then W8A8-static (`quantize_vision_` and
   `GroveForCausalLM.calibrate` on the first clip): the device total, the
   ops with the most self device time and the kernels with the most.

Prints the card's name and power limit first. Exits non-zero without CUDA.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch

# (label, M, K, N) of the towers' int8 GEMMs, 2 clips x 8 frames
GEMMS = [("CLIP q/k/v/out_proj", 9232, 1024, 1024),
         ("CLIP fc1", 9232, 1024, 4096), ("CLIP fc2", 9232, 4096, 1024),
         ("CLIP adapter tap", 9216, 1024, 1024),
         ("SAM window qkv", 28224, 1280, 3840),
         ("SAM window proj", 28224, 1280, 1280),
         ("SAM window lin1", 28224, 1280, 5120),
         ("SAM window lin2", 28224, 5120, 1280),
         ("SAM global qkv", 16384, 1280, 3840),
         ("SAM global lin1", 16384, 1280, 5120),
         ("SAM adapter tap", 16384, 1280, 1280)]
TOP = 12                 # rows printed per table


def _ms(fn, reps=20):
    for _ in range(3):
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


def int_mm_layouts(gpu: str) -> None:
    from .ops.int8_matmul import column_major
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"torch._int_mm by layout of the second operand ({gpu}):")
    for label, m, k, n in GEMMS:
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        row = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                            dtype=torch.int8)
        col = column_major(row)
        if not torch.equal(torch._int_mm(a, row), torch._int_mm(a, col)):
            raise RuntimeError(f"{label}: the two layouts disagree")
        ab, bb = a.to(torch.bfloat16), row.to(torch.bfloat16)
        t_row = _ms(lambda: torch._int_mm(a, row))
        t_col = _ms(lambda: torch._int_mm(a, col))
        t_bf = _ms(lambda: torch.matmul(ab, bb))
        tera = 2 * m * k * n / 1e9
        print(f"  {label} ({m}, {k}) @ ({k}, {n}): row-major {t_row:.4f} ms "
              f"{tera / t_row:.0f} TOP/s, column-major {t_col:.4f} ms "
              f"{tera / t_col:.0f} TOP/s; bf16 matmul {t_bf:.4f} ms "
              f"{tera / t_bf:.0f} TF/s", flush=True)


def _self_device_us(e) -> float:
    return float(getattr(e, "self_device_time_total", 0.0))


def profile_towers(model, fc, fs, label: str, gpu: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def towers():
        model.encode_video(fc)
        model.encode_grounding_auto(fs)

    with torch.inference_mode():
        for name, fn in (("CLIP", lambda: model.encode_video(fc)),
                         ("SAM", lambda: model.encode_grounding_auto(fs))):
            print(f"{label} {name} stage: {_ms(fn, reps=5):.1f} ms (CUDA "
                  f"events, median of 5)", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            towers()
            torch.cuda.synchronize()
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    ops = [e for e in rows if e.device_type != DeviceType.CUDA
           and _self_device_us(e) > 0]
    total = sum(_self_device_us(e) for e in kernels) / 1e3
    print(f"{label} towers, 2 clips x 8 frames: device total {total:.1f} ms "
          f"(self device time of every kernel; {gpu})")
    for what, evs in (("ops", ops), ("kernels", kernels)):
        evs = sorted(evs, key=_self_device_us, reverse=True)[:TOP]
        print(f"  {label}, {what} by self device time:")
        for e in evs:
            print(f"    {_self_device_us(e) / 1e3:9.2f} ms  {e.count:6d} "
                  f"calls  {e.key[:90]}")
    sys.stdout.flush()


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_towers: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from grove_tpu.config import GroveConfig

    from . import _kernels
    from .api import GroveForCausalLM
    from .ops.quant import quantize_vision_

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(gpu, flush=True)
    _kernels.build()
    _kernels.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    int_mm_layouts(gpu)

    lm = GroveForCausalLM.from_pretrained(None, "full", device="cuda",
                                          dtype=torch.bfloat16, seed=0)
    cfg: GroveConfig = lm.cfg
    rng = np.random.default_rng(1)
    nf, c, s = cfg.num_frames, cfg.clip.image_size, cfg.sam_enc.img_size
    fc = torch.from_numpy(rng.integers(0, 256, (2, nf, c, c, 3), np.uint8)
                          ).cuda()
    fs = torch.from_numpy(rng.integers(0, 256, (2, nf, s, s, 3), np.uint8)
                          ).cuda()
    profile_towers(lm.model, fc, fs, "bf16", gpu)
    quantize_vision_(lm.model)
    lm.calibrate(fc[:1].cpu().numpy(), fs[:1].cpu().numpy())
    profile_towers(lm.model, fc, fs, "W8A8-static", gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
