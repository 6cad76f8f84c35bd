"""K6's launch plan and a model of its cluster split, on the CPU.

The CUDA kernel (`csrc/int8_decode_attention.cu`) gives each (batch, kv
head) one thread-block cluster whose ranks split the C cache slots; each
rank streams its K and V slices into shared memory, the ranks combine the
softmax's max and then its sum in rank order before the weights are
rounded as the TPU kernel rounds them, and add their outputs in rank
order. `ops.decode_attention._plan` chooses the split and sizes the launch
for an H100's 132 SMs; checked here:

* the ranks' ranges cover [0, C) once, each non-empty and starting on a
  multiple of 8 slots;
* a CTA's shared memory fits 232,448 bytes;
* the full-width decode step (B 2, H = Hkv 32, C 768, D 128) is one wave:
  clusters of 2, 128 CTAs on 132 SMs;
* `int8_cache_decode_attention_split_torch`, the split's arithmetic in
  torch ops, against the JAX package's `int8_cache_decode_attention`
  (Pallas interpret mode) within 1e-4 of the output's max-abs: GQA, a rank
  whose slots are all masked (its share exact zeros), and C not a multiple
  of the ranks times 128.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import decode_attention as jdec  # noqa: E402
from grove_tpu_torch.config import GroveConfig  # noqa: E402
from grove_tpu_torch.ops import decode_attention as tdec  # noqa: E402

SMS = 132                    # an H100's SMs
SMEM_227KB = 232448          # shared bytes a block can use on sm_90
KERNEL_TOL = 1e-4            # of the output's max-abs, as K6's twin


def _llama_shapes():
    """(B, H, Hkv, C, D) of the int8-cache decode steps the port runs:
    GroveConfig() at phase 3's 2 x 768 slots, small() and a long cache."""
    out = []
    for cfg, b, c in ((GroveConfig().llama, 2, 768),
                      (GroveConfig().llama, 1, 4096),
                      (GroveConfig.small().llama, 1, 640)):
        out.append((b, cfg.num_heads, cfg.num_kv_heads, c, cfg.head_dim))
    return out


# chip_smoke.py's K6 shapes: the full width, GQA, D 64 and 128, C 128-768
SHAPES = _llama_shapes() + [
    (2, 8, 2, 256, 64), (2, 4, 4, 128, 128), (1, 12, 12, 640, 64),
    (2, 8, 2, 384, 128), (2, 12, 4, 128, 64), (2, 16, 2, 768, 128),
    (2, 8, 8, 768, 128)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_covers_the_slots_once_and_fits(shape):
    b, h, hkv, c, d = shape
    p = tdec._plan(b, h, hkv, c, d, SMS)
    assert len(p.ranges) == p.cluster and 1 <= p.cluster <= 8
    assert [s for a, e in p.ranges for s in range(a, e)] == list(range(c))
    assert all(e > a and a % 8 == 0 for a, e in p.ranges)
    assert p.span == max(e - a for a, e in p.ranges)
    assert p.smem == tdec._smem(p.ring, p.span, h // hkv, d)
    assert p.smem <= SMEM_227KB
    assert p.ring == tdec.RING
    assert p.ctas == b * hkv * p.cluster


def test_full_width_is_one_wave():
    """B Hkv = 64 clusters of 2: 128 CTAs on 132 SMs, each rank's K and V
    (384 slots of 128 bytes, 48 KB each) in 6 copies through 2 buffers."""
    p = tdec._plan(2, 32, 32, 768, 128, SMS)
    assert (p.cluster, p.ctas, p.ranges, p.ring) == (
        2, 128, ((0, 384), (384, 768)), 2)
    assert p.ctas <= SMS


def test_plan_is_memoised():
    assert tdec._plan(2, 32, 32, 768, 128, SMS) is \
        tdec._plan(2, 32, 32, 768, 128, SMS)


@pytest.mark.parametrize("d", [8, 40, 144])
def test_plan_refuses_what_the_kernel_does_not_take(d):
    """D off a multiple of 16 or above 128: ValueError (the bulk copies
    move whole 16-byte chunks of a slot's row)."""
    with pytest.raises(ValueError, match="multiple of 16"):
        tdec._plan(2, 4, 4, 256, d, SMS)


@pytest.mark.parametrize("c", [4, 260, 1001])
def test_plan_refuses_a_cache_off_a_multiple_of_8(c):
    """The ranks start on multiples of 8 slots, so that every bulk copy of
    the cache, its scales and the bias lies on 16 bytes; the model pads C
    to a multiple of 128 (`models.llama.init_kv_caches`)."""
    with pytest.raises(ValueError, match="multiple of 8"):
        tdec._plan(2, 4, 4, c, 64, SMS)


def test_plan_refuses_a_cache_too_long_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tdec._plan(1, 32, 32, 1 << 18, 128, SMS)


def test_long_cache_reuses_the_ring():
    """4096 slots in clusters of 4 (32 kv heads, one wave): 1024 a rank,
    16 copies through the ring's 2 buffers."""
    p = tdec._plan(1, 32, 32, 4096, 128, SMS)
    assert (p.cluster, p.span, p.ring) == (4, 1024, 2)
    assert p.smem <= SMEM_227KB


# ---------------------------------------------------------------------------
# the split's arithmetic against the Pallas kernel
# ---------------------------------------------------------------------------

def _case(seed, b, h, hkv, c, d, masks):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kt, vt = (rng.integers(-127, 128, size=(b, hkv, c, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, size=(b, hkv, c)).astype(np.float32)
              for _ in range(2))
    bias = np.zeros((b, c), np.float32)
    for row, lo, hi in masks:
        bias[row, lo:hi] = tdec.NEG_INF
    jargs = (jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt),
             jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16),
             jnp.asarray(bias))
    targs = tuple(torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) if i in (3, 4) else torch.from_numpy(a)
        for i, a in enumerate((q, kt, vt, ks, vs, bias)))
    return jargs, targs


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


# (B, H, Hkv, C, D, ranges or None for the plan's, masked (row, lo, hi))
SPLITS = {
    # GQA, the plan's 4 ranks of 96 slots (C = 384 is no multiple of the
    # 4 ranks times 128)
    "gqa": (2, 8, 2, 384, 64, None,
            [(0, 300, 384), (1, 0, 7), (1, 200, 384)]),
    # two ranks of 192: batch 0's second rank all masked (the unwritten
    # tail), batch 1's first rank all masked (a long left pad)
    "masked rank": (2, 4, 4, 384, 128, ((0, 192), (192, 384)),
                    [(0, 192, 384), (1, 0, 195)]),
    # three ranks of uneven length, GQA 3
    "uneven ranks": (2, 6, 2, 256, 64, ((0, 85), (85, 170), (170, 256)),
                     [(0, 200, 256), (1, 0, 9)]),
    # the full-width step's split at one batch row and four kv heads
    "full-width split": (1, 4, 4, 768, 128, None, [(0, 700, 768)]),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_model_matches_pallas(name):
    b, h, hkv, c, d, ranges, masks = SPLITS[name]
    ranges = ranges or tdec._plan(b, h, hkv, c, d, SMS).ranges
    assert len(ranges) > 1
    jargs, targs = _case(16, b, h, hkv, c, d, masks)
    want = jdec.int8_cache_decode_attention(*jargs)
    got = tdec.int8_cache_decode_attention_split_torch(*targs, ranges)
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    _rel_close(got, want, KERNEL_TOL)
    _rel_close(got, tdec.int8_cache_decode_attention_torch(*targs),
               KERNEL_TOL)


def test_all_masked_rank_adds_exact_zeros():
    """A rank whose slots are all masked gets e = exp(-1e9 - max) = 0 and
    adds nothing: batch 0 with its second rank masked equals, bit for bit,
    the split over the first rank's slots alone."""
    b, h, hkv, c, d, ranges, masks = SPLITS["masked rank"]
    _, targs = _case(16, b, h, hkv, c, d, masks)
    got = tdec.int8_cache_decode_attention_split_torch(*targs, ranges)
    q, kt, vt, ks, vs, bias = (t[:1] for t in targs)
    head = tdec.int8_cache_decode_attention_split_torch(
        q, kt[:, :, :192].contiguous(), vt[:, :, :192].contiguous(),
        ks[:, :, :192].contiguous(), vs[:, :, :192].contiguous(),
        bias[:, :192].contiguous(), ((0, 192),))
    assert torch.equal(got[:1], head)
