"""K14's launch plan and wrappers (`window_partition_fused`,
`window_unpartition_fused`, `csrc/window_partition.cu`) on the CPU.

`ops.window_ops.window_copy_plan` lists the rows the kernel moves: for
each, its source and destination bytes, the bytes copied and the zero
bytes written after them, the CTA that moves it and the body chosen.
Executed with numpy copies into a buffer filled with a sentinel byte, it
writes every output byte exactly once and gives `window_partition_torch`
(after torch's pad) and `window_unpartition_torch` (before the slice)
bit for bit, in fp32, bf16 and int8: on exact divisors, a pad on one axis
and on both, H and W below one window, more rows than CTAs and fewer, and
C on both sides of the bulk body's 16-byte rule.

The wrappers on the CPU equal the JAX package's `window_partition_fused`
and `window_unpartition_fused` (Pallas, interpret mode) and their VJPs
bit for bit. Their CUDA branch, driven past `on_cpu` with the launch
replaced by the plan's numpy execution, passes the kernel the unpadded
grid, runs no `F.pad` and returns a contiguous (B, H, W, C).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import window_ops as jwin  # noqa: E402
from grove_tpu_torch import _kernels  # noqa: E402
from grove_tpu_torch.ops import window_ops as twin  # noqa: E402

SMS = 132                    # an H100's SMs
SMEM_227KB = 232448          # shared bytes a block can use on sm_90
SENTINEL = 0xA5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}

# (b, h, w, c, win): exact divisors; a pad on W only; a pad on both; H and
# W below one window; SAM's 32 -> 42 pad at a small C. C = 16 is 16 bytes
# or more in every dtype: the bulk body
SHAPES = [(2, 8, 8, 16, 4), (1, 8, 10, 16, 4), (2, 10, 9, 16, 4),
          (1, 3, 2, 16, 4), (2, 30, 30, 16, 14)]
# C on the other side of the 16-byte rule in each dtype: 40 B of bf16,
# 12 B of fp32, 8 B of int8 take the vector body
NARROW = {"float32": 3, "bfloat16": 20, "int8": 8}


def _grid(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return torch.from_numpy(
            rng.integers(-127, 128, size=shape).astype(np.int8))
    return torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(DTYPES[dtype])


def _bytes(t):
    """A contiguous tensor's bytes as a numpy uint8 array (a copy)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().copy()


def _run(plan, src, out_shape, dtype):
    """Execute `plan` on `src`'s bytes into a sentinel-filled output of
    `out_shape`; return it and how often each output byte was written."""
    s = _bytes(src)
    n = int(np.prod(out_shape)) * src.element_size()
    out = np.full(n, SENTINEL, np.uint8)
    hits = np.zeros(n, np.int32)
    for a, d, v, z in zip(plan.src, plan.dst, plan.valid, plan.zero):
        out[d:d + v] = s[a:a + v]
        out[d + v:d + v + z] = 0
        hits[d:d + v + z] += 1
    t = torch.from_numpy(out).view(dtype).reshape(out_shape)
    return t, hits


def _padded(x, win):
    b, h, w, c = x.shape
    return torch.nn.functional.pad(x, (0, 0, 0, (-w) % win, 0, (-h) % win))


def _check_plan(plan, rows, itemsize, c, sms):
    assert plan.rows == rows and plan.cta.shape == (rows,)
    if plan.body == "bulk":
        assert c * itemsize % 16 == 0
        assert 2 <= plan.slots <= twin.WINDOW_MAX_SLOTS
        assert plan.smem <= SMEM_227KB
        assert plan.ctas == min(rows, plan.per_sm * sms)
        np.testing.assert_array_equal(plan.cta, np.arange(rows) % plan.ctas)
        # every row, its zeros and every bulk copy 16-byte aligned
        for a in (plan.src, plan.dst, plan.valid, plan.zero):
            assert np.all(a % 16 == 0)
    else:
        assert plan.ctas == rows
        np.testing.assert_array_equal(plan.cta, np.arange(rows))


@pytest.mark.parametrize("sms", [1, SMS])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_partition_plan_is_the_padded_copy(dtype, shape, narrow, sms):
    """The partition's plan, executed, is torch's pad + window copy bit for
    bit and writes every byte of the windows once: the pad's zeros included,
    nothing read from the pad."""
    b, h, w, c, win = shape
    c = NARROW[dtype] if narrow else c
    x = _grid(dtype, (b, h, w, c))
    want = twin.window_partition_torch(_padded(x, win), win)
    plan = twin.window_copy_plan(b, h, w, c, win, x.element_size(), sms,
                                 False)
    assert plan.body == ("vector" if narrow else "bulk")
    _check_plan(plan, want.shape[0] * win, x.element_size(), c, sms)
    if plan.body == "bulk" and sms == 1:
        assert plan.ctas < plan.rows           # more rows than CTAs
    if plan.body == "bulk" and sms == SMS:
        assert plan.ctas == plan.rows          # fewer rows than CTAs
    got, hits = _run(plan, x, tuple(want.shape), x.dtype)
    assert np.all(hits == 1)
    assert torch.equal(got, want)
    # what it reads: each valid pixel of x once
    assert int(plan.valid.sum()) == x.numel() * x.element_size()


@pytest.mark.parametrize("sms", [1, SMS])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unpartition_plan_is_the_copy_without_the_pad(dtype, shape, narrow,
                                                      sms):
    """The unpartition's plan, executed, is torch's window copy with the
    pad sliced off, bit for bit, into a contiguous (B, H, W, C), every byte
    written once and no byte of the pad read."""
    b, h, w, c, win = shape
    c = NARROW[dtype] if narrow else c
    gh, gw = -(-h // win), -(-w // win)
    wins = _grid(dtype, (b * gh * gw, win, win, c), seed=1)
    want = twin.window_unpartition_torch(wins, win, b, gh * win,
                                         gw * win)[:, :h, :w]
    plan = twin.window_copy_plan(b, h, w, c, win, wins.element_size(), sms,
                                 True)
    assert plan.body == ("vector" if narrow else "bulk")
    _check_plan(plan, b * h * gw, wins.element_size(), c, sms)
    assert not plan.zero.any()
    got, hits = _run(plan, wins, (b, h, w, c), wins.dtype)
    assert np.all(hits == 1)
    assert torch.equal(got, want)
    # the bytes read are the valid pixels, each once
    read = np.zeros(wins.numel() * wins.element_size(), np.int32)
    for a, v in zip(plan.src, plan.valid):
        read[a:a + v] += 1
    assert int(read.sum()) == b * h * w * c * wins.element_size()
    assert read.max() == 1


def test_full_width_plan():
    """SAM ViT-H's 16 frames, (16, 32, 32, 1280) bf16 in windows of 14
    (32 pads to 42): both directions take the bulk body, 3 row slots of
    35,840 B, 2 CTAs an SM on 132 SMs; the bytes they move are the bounds'
    (the partition 41.94 MB read and 72.25 MB written with its zeros, the
    unpartition 41.94 MB each way)."""
    grid = 16 * 32 * 32 * 1280 * 2
    part = twin.window_copy_plan(16, 32, 32, 1280, 14, 2, SMS, False)
    unpart = twin.window_copy_plan(16, 32, 32, 1280, 14, 2, SMS, True)
    assert (part.body, part.slots, part.per_sm, part.ctas, part.rows) == (
        "bulk", 3, 2, 264, 16 * 9 * 14)
    assert (unpart.body, unpart.slots, unpart.per_sm, unpart.ctas,
            unpart.rows) == ("bulk", 3, 2, 264, 16 * 32 * 3)
    assert part.smem == 3 * 35840 + twin.WINDOW_ZERO_BYTES + 24
    assert unpart.smem == 3 * 35840 + 24
    assert int(part.valid.sum()) == int(unpart.valid.sum()) == grid
    assert int((part.valid + part.zero).sum()) == 144 * 14 * 14 * 1280 * 2


@pytest.mark.parametrize("unpartition", [False, True])
def test_rows_too_wide_for_two_slots_take_the_vector_body(unpartition):
    """A window row of win * C * itemsize bytes that leaves no room for two
    slots in 227 KB (fp32 at C = 8192, 458,752 B) takes the vector body."""
    plan = twin.window_copy_plan(1, 14, 14, 8192, 14, 4, SMS, unpartition)
    assert plan.body == "vector" and plan.ctas == plan.rows


def test_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        twin.window_copy_plan(1, 0, 14, 8, 14, 2, SMS, False)


# ---------------------------------------------------------------------------
# the wrappers against the JAX package
# ---------------------------------------------------------------------------

# (dtype, (b, h, w, c), win): the shapes above in each dtype; bf16 through
# jnp.bfloat16 arrays of the same values
WRAPPER_CASES = [("float32", (2, 10, 9, 8), 4), ("bfloat16", (1, 8, 8, 16), 4),
                 ("int8", (1, 3, 2, 16), 4), ("bfloat16", (2, 30, 30, 20), 14),
                 ("int8", (1, 7, 9, 8), 4)]


def _jax(x):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _equal(got, want):
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        assert want.dtype == jnp.bfloat16
        got, want = got.float().numpy(), want.astype(np.float32)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,shape,win", WRAPPER_CASES)
def test_wrappers_match_jax(dtype, shape, win):
    x = _grid(dtype, shape, seed=3)
    want = jwin.window_partition_fused(_jax(x), win)
    got = twin.window_partition_fused(x, win)
    _equal(got, want)
    back = twin.window_unpartition_fused(got, win, shape[1:3])
    _equal(back, jwin.window_unpartition_fused(want, win, shape[1:3]))
    assert torch.equal(back, x)


@pytest.mark.parametrize("dtype,shape,win", [WRAPPER_CASES[0],
                                             WRAPPER_CASES[3]])
def test_wrapper_vjps_match_jax(dtype, shape, win):
    """Each direction's backward is the other direction, as JAX's custom
    VJPs are: against `jax.vjp` of each, bit for bit."""
    x = _grid(dtype, shape, seed=4)
    hw = shape[1:3]
    wins = twin.window_partition_fused(x, win)
    gp, gu = _grid(dtype, tuple(wins.shape), 5), _grid(dtype, shape, 6)
    _, vjp_p = jax.vjp(lambda a: jwin.window_partition_fused(a, win), _jax(x))
    _, vjp_u = jax.vjp(lambda a: jwin.window_unpartition_fused(a, win, hw),
                       _jax(wins))
    tx, tw = x.clone().requires_grad_(), wins.clone().requires_grad_()
    (dx,) = torch.autograd.grad(twin.window_partition_fused(tx, win), tx, gp)
    (dw,) = torch.autograd.grad(twin.window_unpartition_fused(tw, win, hw),
                                tw, gu)
    _equal(dx, vjp_p(_jax(gp))[0])
    _equal(dw, vjp_u(_jax(gu))[0])


@pytest.mark.parametrize("dtype,shape,win", WRAPPER_CASES)
def test_card_branch_passes_the_unpadded_grid(monkeypatch, dtype, shape,
                                              win):
    """The wrappers' CUDA branch (`on_cpu` False), with the launch replaced
    by the plan's numpy execution on the arguments the kernel would get:
    no `F.pad`, the unpadded (B, H, W) and win handed over, the windows and
    a contiguous (B, H, W, C) allocated, both equal to the CPU branch's."""
    launched = []

    def launch(kernel, src, out, b, h, w, win_):
        launched.append((kernel, b, h, w, win_))
        plan = twin.window_copy_plan(b, h, w, src.shape[-1], win_,
                                     src.element_size(), SMS,
                                     kernel == "window_unpartition")
        got, hits = _run(plan, src, tuple(out.shape), src.dtype)
        assert np.all(hits == 1)
        out.copy_(got)
        return out

    def no_pad(*a, **k):
        raise AssertionError("F.pad on the card's branch")

    x = _grid(dtype, shape, seed=7)
    want = twin.window_partition_fused(x, win)
    back_want = twin.window_unpartition_fused(want, win, shape[1:3])
    monkeypatch.setattr(_kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(twin, "_copy", launch)
    monkeypatch.setattr(twin.F, "pad", no_pad)
    got = twin.window_partition_fused(x, win)
    back = twin.window_unpartition_fused(got, win, shape[1:3])
    b, h, w, _ = shape
    assert launched == [("window_partition", b, h, w, win),
                        ("window_unpartition", b, h, w, win)]
    assert torch.equal(got, want)
    assert back.is_contiguous() and torch.equal(back, back_want)
