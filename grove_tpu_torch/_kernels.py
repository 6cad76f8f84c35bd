"""Build and bind the hand-written CUDA kernels of grove_tpu_torch.

The sources in `csrc/` are compiled with nvcc for `sm_90a` into one shared
library with a plain C interface, at first use, into `_build/` (listed in
.gitignore). The library's name carries a hash of the sources and flags, so
an edited source rebuilds. It is loaded with ctypes: every pointer and the
stream are `c_void_p`, and each entry point returns `cudaGetLastError()`,
which `Kernel.__call__` turns into an exception.

Nothing here runs at import, so a machine without nvcc or a card can import
every module of the package (the CPU tests do). `on_cpu`, which every
wrapper asks before it launches, also holds the grad guard
(`check_no_grad`): a kernel's output has no `grad_fn`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# head dims the kernels are instantiated for (attention_core.cuh), and the
# ones the tensor-core bodies take, in bf16 only (attention_tc.cuh and
# attention_bwd_tc.cuh: 64 and 128, LLaMA's and CLIP's, and 80, SAM's, whose
# rows fill one 64-column swizzle atom and 16 columns of a second)
HEAD_DIMS = (8, 64, 80, 128)
TC_HEAD_DIMS = (64, 80, 128)
MAX_BATCH_HEADS = 65535          # gridDim.y

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libgrove_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (looked on PATH, $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): the CUDA kernels of "
                       "grove_tpu_torch cannot be built")


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per file, in parallel) and link them into
    the hashed library; a no-op when it already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for src, _, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        lib = tmp / out.name
        link = [nvcc, "-shared", *ARCH_FLAGS, *(str(o) for _, o, _ in jobs),
                "-o", str(lib)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for k in KERNELS.values():
                fn = getattr(lib, k.symbol)
                fn.argtypes = list(k.argtypes)
                fn.restype = ctypes.c_int
            lib.grove_error_string.argtypes = [ctypes.c_int]
            lib.grove_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class Kernel:
    """One C entry point of the library and its launch count.

    `launches` goes up by one after each launch the card accepted, and
    nowhere else; `chip_smoke.py` zeroes it before the main path and reads
    it after, to show which kernels that path ran."""

    def __init__(self, symbol: str, argtypes: Sequence, source: str,
                 replaces: str):
        self.symbol = symbol
        self.argtypes = tuple(argtypes)
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __call__(self, *args) -> None:
        lib = load()
        code = getattr(lib, self.symbol)(*args)
        if code != 0:
            msg = lib.grove_error_string(code).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {code}: {msg}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {
    "sam_window_attention": Kernel(
        "grove_sam_window_attention",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/sam_window_attention.cu",
        "grove_tpu/ops/sam_attention.py:537"),
    "sam_global_attention": Kernel(
        "grove_sam_global_attention",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/sam_global_attention.cu",
        "grove_tpu/ops/sam_attention.py:235"),
    # K1, K1q, K2, K3, K4, K5, K9's forward, K10, K11, K12, K12q8 and K13 on
    # the tensor-core body (attention_tc.cuh), which the wrappers take for bf16
    # at head dims 64, 80 and 128 (`TC_HEAD_DIMS`); fp32 and the head dim 8
    # take the SIMT entries
    "sam_window_attention_tc": Kernel(
        "grove_sam_window_attention_tc",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/sam_window_attention.cu",
        "grove_tpu/ops/sam_attention.py:537"),
    "sam_global_attention_tc": Kernel(
        "grove_sam_global_attention_tc",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/sam_global_attention.cu",
        "grove_tpu/ops/sam_attention.py:235"),
    "grouped_plain_attention": Kernel(
        "grove_grouped_plain_attention",
        [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/grouped_plain_attention.cu",
        "grove_tpu/ops/attention.py:404"),
    "grouped_plain_attention_tc": Kernel(
        "grove_grouped_plain_attention_tc",
        [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/grouped_plain_attention.cu",
        "grove_tpu/ops/attention.py:404"),
    "flash_forward_lse": Kernel(
        "grove_flash_forward_lse",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/flash_forward_lse.cu",
        "grove_tpu/ops/flash_backward.py:210"),
    "flash_forward_lse_tc": Kernel(
        "grove_flash_forward_lse_tc",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/flash_forward_lse.cu",
        "grove_tpu/ops/flash_backward.py:210"),
    "prefill_attention": Kernel(
        "grove_prefill_attention",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/prefill_attention.cu",
        "grove_tpu/ops/attention.py:248"),
    "prefill_attention_tc": Kernel(
        "grove_prefill_attention_tc",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/prefill_attention.cu",
        "grove_tpu/ops/attention.py:248"),
    "int8_decode_attention": Kernel(
        "grove_int8_decode_attention",
        [_P] * 7 + [_I] * 7 + [_F, _I, _P],
        "grove_tpu_torch/csrc/int8_decode_attention.cu",
        "grove_tpu/ops/decode_attention.py:122"),
    "int4_matmul": Kernel(
        "grove_int4_matmul",
        [_P] * 4 + [_I] * 9 + [_P],
        "grove_tpu_torch/csrc/int4_matmul.cu",
        "grove_tpu/ops/int4_matmul.py:317"),
    "layernorm_quant": Kernel(
        "grove_layernorm_quant",
        [_P, _P, _P, _P, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/layernorm_quant.cu",
        "grove_tpu/ops/fused_ln.py:213"),
    "add_layernorm_quant": Kernel(
        "grove_add_layernorm_quant",
        [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/layernorm_quant.cu",
        "grove_tpu/ops/fused_ln.py:68"),
    "sam_window_attention_q8": Kernel(
        "grove_sam_window_attention_q8",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/sam_window_attention.cu",
        "grove_tpu/ops/sam_attention.py:537"),
    "sam_window_attention_q8_tc": Kernel(
        "grove_sam_window_attention_q8_tc",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/sam_window_attention.cu",
        "grove_tpu/ops/sam_attention.py:537"),
    "int4_matmul_a8": Kernel(
        "grove_int4_matmul_a8",
        [_P] * 5 + [_I] * 9 + [_P],
        "grove_tpu_torch/csrc/int4_matmul_a8.cu",
        "grove_tpu/ops/int4_matmul.py:372"),
    "int4_requant_int8": Kernel(
        "grove_int4_requant_int8",
        [_P, _P, _P, _I, _I, _I, _P],
        "grove_tpu_torch/csrc/int4_requant.cu",
        "grove_tpu/ops/int4_matmul.py:270"),
    "rmsnorm_quant": Kernel(
        "grove_rmsnorm_quant",
        [_P, _P, _P, _P, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/rmsnorm_quant.cu",
        "grove_tpu/ops/fused_ln.py:155"),
    "add_rmsnorm_quant": Kernel(
        "grove_add_rmsnorm_quant",
        [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
        "grove_tpu_torch/csrc/rmsnorm_quant.cu",
        "grove_tpu/ops/fused_ln.py:162"),
    "flash_backward_dq": Kernel(
        "grove_flash_backward_dq",
        [_P] * 7 + [_I] * 5 + [_F, _I, _P],
        "grove_tpu_torch/csrc/flash_backward.cu",
        "grove_tpu/ops/flash_backward.py:253"),
    "flash_backward_dkv": Kernel(
        "grove_flash_backward_dkv",
        [_P] * 8 + [_I] * 5 + [_F, _I, _P],
        "grove_tpu_torch/csrc/flash_backward.cu",
        "grove_tpu/ops/flash_backward.py:278"),
    # K4b's dq and dkv on the tensor-core backward body
    # (attention_bwd_tc.cuh), taken where `TC_HEAD_DIMS` holds, as the
    # forward entries
    "flash_backward_dq_tc": Kernel(
        "grove_flash_backward_dq_tc",
        [_P] * 7 + [_I] * 5 + [_F, _I, _P],
        "grove_tpu_torch/csrc/flash_backward.cu",
        "grove_tpu/ops/flash_backward.py:253"),
    "flash_backward_dkv_tc": Kernel(
        "grove_flash_backward_dkv_tc",
        [_P] * 8 + [_I] * 5 + [_F, _I, _P],
        "grove_tpu_torch/csrc/flash_backward.cu",
        "grove_tpu/ops/flash_backward.py:278"),
    "relpos_flash_fwd_lse": Kernel(
        "grove_relpos_flash_fwd_lse",
        [_P] * 7 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/relpos_flash_attention.cu",
        "grove_tpu/ops/sam_attention_bwd.py:243"),
    "relpos_flash_fwd_lse_tc": Kernel(
        "grove_relpos_flash_fwd_lse_tc",
        [_P] * 7 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/relpos_flash_attention.cu",
        "grove_tpu/ops/sam_attention_bwd.py:243"),
    "relpos_flash_dq": Kernel(
        "grove_relpos_flash_dq",
        [_P] * 11 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/relpos_flash_attention.cu",
        "grove_tpu/ops/sam_attention_bwd.py:294"),
    # K9's dq on the tensor-core backward body, taken where `TC_HEAD_DIMS`
    # holds and the term tables suit its copies
    "relpos_flash_dq_tc": Kernel(
        "grove_relpos_flash_dq_tc",
        [_P] * 11 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/relpos_flash_attention.cu",
        "grove_tpu/ops/sam_attention_bwd.py:294"),
    "relpos_flash_dkv": Kernel(
        "grove_relpos_flash_dkv",
        [_P] * 10 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/relpos_flash_attention.cu",
        "grove_tpu/ops/sam_attention_bwd.py:333"),
    # K9's dkv on the tensor-core backward body, taken as its dq's
    "relpos_flash_dkv_tc": Kernel(
        "grove_relpos_flash_dkv_tc",
        [_P] * 10 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/relpos_flash_attention.cu",
        "grove_tpu/ops/sam_attention_bwd.py:333"),
    "flash_attention": Kernel(
        "grove_flash_attention",
        [_P] * 4 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/flash_attention.cu",
        "grove_tpu/ops/attention.py:154"),
    "flash_attention_tc": Kernel(
        "grove_flash_attention_tc",
        [_P] * 4 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/flash_attention.cu",
        "grove_tpu/ops/attention.py:154"),
    # K11-K14: public ops of the JAX package that no model path dispatches
    "flash_attention_relpos": Kernel(
        "grove_relpos_flash_attention",
        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/streamed_relpos_attention.cu",
        "grove_tpu/ops/sam_attention.py:133"),
    # K11 on the tensor-core forward body (K2's), taken as K2's
    "flash_attention_relpos_tc": Kernel(
        "grove_relpos_flash_attention_tc",
        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/streamed_relpos_attention.cu",
        "grove_tpu/ops/sam_attention.py:133"),
    "sam_window_attention_v2": Kernel(
        "grove_sam_window_attention_v2",
        [_P] * 5 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/sam_window_attention_v2.cu",
        "grove_tpu/ops/sam_attention.py:598"),
    # K12 on the tensor-core forward body (K1's packed-table
    # instantiation), taken as K1's
    "sam_window_attention_v2_tc": Kernel(
        "grove_sam_window_attention_v2_tc",
        [_P] * 5 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/sam_window_attention_v2.cu",
        "grove_tpu/ops/sam_attention.py:598"),
    "sam_window_attention_v2_q8": Kernel(
        "grove_sam_window_attention_v2_q8",
        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/sam_window_attention_v2.cu",
        "grove_tpu/ops/sam_attention.py:640"),
    # K12q8 on the tensor-core forward body (K1q's instantiation on split
    # q, k, v), taken as K1q's
    "sam_window_attention_v2_q8_tc": Kernel(
        "grove_sam_window_attention_v2_q8_tc",
        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/sam_window_attention_v2.cu",
        "grove_tpu/ops/sam_attention.py:640"),
    "folded_window_attention": Kernel(
        "grove_folded_window_attention",
        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/folded_window_attention.cu",
        "grove_tpu/ops/sam_attention.py:327"),
    # K13 v1 on the tensor-core forward body (K2's biased instantiation,
    # which K13 v2 runs too), taken as K2's
    "folded_window_attention_tc": Kernel(
        "grove_folded_window_attention_tc",
        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/folded_window_attention.cu",
        "grove_tpu/ops/sam_attention.py:327"),
    "folded_window_attention_v2": Kernel(
        "grove_folded_window_attention_v2",
        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/folded_window_attention.cu",
        "grove_tpu/ops/sam_attention.py:818"),
    # K13 v2 on the tensor-core forward body (K2's biased instantiation),
    # taken as K2's
    "folded_window_attention_v2_tc": Kernel(
        "grove_folded_window_attention_v2_tc",
        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
        "grove_tpu_torch/csrc/folded_window_attention.cu",
        "grove_tpu/ops/sam_attention.py:818"),
    "window_partition": Kernel(
        "grove_window_partition",
        [_P] * 2 + [_I] * 6 + [_P],
        "grove_tpu_torch/csrc/window_partition.cu",
        "grove_tpu/ops/window_ops.py:59"),
    "window_unpartition": Kernel(
        "grove_window_unpartition",
        [_P] * 2 + [_I] * 6 + [_P],
        "grove_tpu_torch/csrc/window_partition.cu",
        "grove_tpu/ops/window_ops.py:81"),
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the wrapper should take its plain version: the tensors lie
    on the CPU. A CUDA tensor launches the kernel, after `check_no_grad`;
    any other device raises. Every wrapper asks this with all its tensor
    inputs before it launches anything."""
    dev = tensors[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"grove_tpu_torch kernels take CPU or CUDA tensors, "
                         f"got {tensors[0].device}")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("kernel inputs lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev == "cpu":
        return True
    check_no_grad(tensors)
    return False


def check_no_grad(tensors: Sequence[torch.Tensor]) -> None:
    """The grad guard: a kernel writes its outputs through raw pointers, so
    they carry no `grad_fn` and autograd would stop there without a word.
    Raise when grad mode is on and an input requires grad. The kernels that
    training needs are launched inside `torch.autograd.Function`s (forward
    and backward run with grad mode off, so the guard passes); serving runs
    under `torch.no_grad` / `torch.inference_mode`. On the CPU the plain
    twins are differentiable and the guard is not asked."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "a CUDA kernel of grove_tpu_torch was called with grad enabled "
            "on an input that requires grad, and it has no backward: its "
            "output would carry no gradient. Call it under torch.no_grad() "
            "or torch.inference_mode(), or through the op's autograd "
            "Function")


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain twins' compute dtype: fp32, or float64 for float64 inputs
    (so `torch.autograd.gradcheck` can hold the autograd Functions)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def dtype_code(name: str, t) -> int:
    """The kernels' code for a float32 or bfloat16 operand (a tensor, or
    the dtype of an output); raise for any other dtype."""
    dt = t.dtype if isinstance(t, torch.Tensor) else t
    if dt not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dt} not supported "
                         "(float32 or bfloat16)")
    return _DTYPE_CODES[dt]


def check_typed(name: str, pairs) -> None:
    """Raise unless each (tensor, dtype) pair has that dtype and is
    contiguous (the non-float operands of the quantized kernels)."""
    for t, dt in pairs:
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def check_cuda_inputs(name: str, tensors: Sequence[torch.Tensor],
                      head_dim: int, batch_heads: int) -> int:
    """Validate what the kernel `name` takes; return its dtype code."""
    dt = tensors[0].dtype
    dtype_code(name, tensors[0])
    check_typed(name, [(t, dt) for t in tensors])
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {head_dim} not in {HEAD_DIMS}")
    if not 0 < batch_heads <= MAX_BATCH_HEADS:
        raise ValueError(f"{name}: batch * heads = {batch_heads} outside "
                         f"(0, {MAX_BATCH_HEADS}]")
    return _DTYPE_CODES[dt]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's SMs, which the launch plans of K6, K7a and K7b size their
    grids for; memoised, since a decode step plans its launches each call."""
    return torch.cuda.get_device_properties(device).multi_processor_count
