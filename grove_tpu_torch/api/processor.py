"""The user-facing decode options of the inference API.

Counterpart of `grove_tpu/api/processor.py:_decode_kwargs` (`:25-57`). The
rest of that module (`GroveProcessor`: video decode and preprocessing) is
not ported yet (ROADMAP Queue 1 item 8); the JAX module imports
`grove_tpu.data.preprocess`, which needs PIL, so the table is copied here
with torch dtypes, and `tests/test_torch_misc.py` holds it equal to the
original.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

KV_CACHE_DTYPES = {None: torch.bfloat16, "bf16": torch.bfloat16,
                   "bfloat16": torch.bfloat16, "int8": torch.int8,
                   "fp32": torch.float32, "float32": torch.float32}


def _decode_kwargs(kv_cache_dtype: Optional[str], early_stop: bool,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 1.0, seed: Optional[int] = None,
                   num_beams: int = 1,
                   length_penalty: float = 1.0) -> Dict:
    """Map user-facing strings to the decode kwargs of
    `infer.sliding.infer_clips_batched(..., decode_kwargs=...)`; the same
    checks as the JAX function."""
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype must be one of "
                         f"{sorted(k for k in KV_CACHE_DTYPES if k)}, "
                         f"got {kv_cache_dtype!r}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0 < top_p <= 1:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not 1 <= num_beams <= 16:
        raise ValueError(f"num_beams must be in [1, 16], got {num_beams}")
    if temperature == 0 and (top_k > 0 or top_p < 1):
        raise ValueError("top_k/top_p only apply to sampling; "
                         "set temperature > 0")
    if num_beams > 1 and temperature > 0:
        raise ValueError("num_beams > 1 is deterministic; "
                         "drop temperature or use num_beams=1")
    if num_beams > 1 and kv_cache_dtype == "int8":
        raise ValueError("num_beams > 1 requires a reorderable KV cache; "
                         "use kv_cache_dtype='bf16' or 'fp32'")
    if seed is not None and temperature > 0:
        raise NotImplementedError("seeded sampling is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    return {"cache_dtype": KV_CACHE_DTYPES[kv_cache_dtype],
            "early_exit": bool(early_stop),
            "temperature": float(temperature), "top_k": int(top_k),
            "top_p": float(top_p), "num_beams": int(num_beams),
            "length_penalty": float(length_penalty)}
