"""The port's K11-K14 ops against the JAX package's, on the CPU in fp32.

The JAX functions run their Pallas kernels in interpret mode (the default
off a TPU), as `tests/test_sam_attention.py` and `tests/test_window_ops.py`
run them; the port's run their plain twins (CPU tensors). Inputs come from
numpy seeds and are handed to both.

Tolerances: the attention ops within rtol 2e-4, atol 2e-5 (the JAX tests'
own against their XLA path); the int8 epilogue within 1 LSB on at most
0.1% of the outputs (a value within float noise of a .5 may round either
way); the window copies bit-equal; gradients within 1e-4 of max-abs
(`jax.vjp` of the JAX custom VJPs against the port's autograd Functions).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import sam_attention as jsam  # noqa: E402
from grove_tpu.ops import window_ops as jwin  # noqa: E402
from grove_tpu_torch import _kernels  # noqa: E402
from grove_tpu_torch.ops import sam_attention as tsam  # noqa: E402
from grove_tpu_torch.ops import window_ops as twin  # noqa: E402
from test_torch_flash import (K1Q_BF16_SHARE, K1Q_SHARE,  # noqa: E402
                              _k1_inputs)

RTOL, ATOL = 2e-4, 2e-5
GRAD_TOL = 1e-4
LSB_SHARE = 1e-3


def _setup(seed, b=6, g=14, nh=4, d=8):
    rng = np.random.default_rng(seed)
    s = g * g

    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return (f(b, s, nh, d), f(b, s, nh, d), f(b, s, nh, d),
            f(2 * g - 1, d), f(2 * g - 1, d), (g, g))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        err = np.abs(np.asarray(g, np.float32) - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (err, np.abs(w).max())


def _terms(q, rel_h, rel_w, hw):
    """JAX's (B, H, S, gh/gw) rel terms as numpy, handed to both sides."""
    rh, rw = jsam.relpos_terms(jnp.asarray(q), jnp.asarray(rel_h),
                               jnp.asarray(rel_w), hw)
    return np.array(rh), np.array(rw)


def _flat(x):
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


# ---------------------------------------------------------------------------
# K12: split raw q / k / v (v2), its int8 epilogue, the raw-layout VJP
# ---------------------------------------------------------------------------

def _packed(q, rel_h, rel_w, hw, nh):
    return np.array(jsam.relpos_terms_raw(jnp.asarray(_flat(q)),
                                            jnp.asarray(rel_h),
                                            jnp.asarray(rel_w), hw, nh))


@pytest.mark.parametrize("b,nh,d", [(6, 4, 8), (2, 2, 16)])
def test_v2_window_attention_matches_jax(b, nh, d):
    q, k, v, rel_h, rel_w, hw = _setup(0, b=b, nh=nh, d=d)
    rel = _packed(q, rel_h, rel_w, hw, nh)
    raw = [_flat(x) for x in (q, k, v)]
    want = jsam.grouped_window_attention_relpos_v2(*_j(*raw, rel), hw,
                                                   num_heads=nh, group=3)
    got = tsam.grouped_window_attention_relpos_v2(*_t(*raw, rel), hw, nh)
    assert got.shape == (b, 196, nh * d)
    _close(got, want)
    # the port's packed terms are JAX's
    _close(tsam.relpos_terms_raw(*_t(raw[0], rel_h, rel_w), hw, nh), rel,
           1e-5, 1e-5)


@pytest.mark.parametrize("seed", [1, 2])
def test_v2_q8_within_one_lsb_of_jax(seed):
    q, k, v, rel_h, rel_w, hw = _setup(seed)
    nh = q.shape[2]
    raw = [_flat(x) for x in (q, k, v)]
    inv = np.array([96.0], np.float32)          # outputs across the int8 range
    act = np.array(1.0 / 96.0, np.float32)
    want = np.asarray(jsam.sam_window_attention_raw_q8(
        *_j(*raw, rel_h, rel_w), hw, nh, jnp.asarray(act)))
    got = tsam.sam_window_attention_raw_q8(*_t(*raw, rel_h, rel_w), hw, nh,
                                           torch.from_numpy(act)).numpy()
    rel = _packed(q, rel_h, rel_w, hw, nh)
    direct = tsam.grouped_window_attention_relpos_v2_q8(
        *_t(*raw, rel), torch.from_numpy(inv), hw, nh).numpy()
    for out in (got, direct):
        assert out.dtype == np.int8 and out.shape == want.shape
        diff = np.abs(out.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= LSB_SHARE
    assert np.abs(want).max() > 60


def _k12q8_inputs(win, d, heads=2, nw=2, seed=11):
    """K1q's inputs of `test_torch_flash` (bf16 values of an unsplit qkv
    whose row 0 of window 0 underflows everywhere, and its packed term
    table), q, k and v split -> (q, k, v, rel) numpy fp32."""
    qkv, rel = _k1_inputs(np.random.default_rng(seed), nw, win, heads, d)
    c = heads * d
    return (*(np.ascontiguousarray(qkv[..., i * c:(i + 1) * c])
              for i in range(3)), rel)


def _lsb(a, b):
    diff = np.abs(np.asarray(a).astype(np.int32)
                  - np.asarray(b).astype(np.int32))
    return diff.max(), (diff > 0).mean()


@pytest.mark.parametrize("d", [64, 80, 128])
def test_v2_q8_tc_model_within_lsb_of_pallas(d):
    """K12q8 on the tensor-core body (`grouped_window_attention_relpos_v2_
    q8_tc_torch`: P rounded to bf16 before P.V, the sum over the fp32 P,
    the all-underflow rows 0, the int8 epilogue) against the Pallas K12q8
    (`grouped_window_attention_relpos_v2_q8`, interpret mode) on fp32 and
    on bf16 arrays of the same bf16 values, and against the fp32 twin:
    outputs across the int8 range, at most 1 LSB apart on at most the
    shares recorded for K1q's tensor-core twin (K1Q_SHARE against the fp32
    arrays and the twin, K1Q_BF16_SHARE against the bf16 arrays, where the
    TPU kernel rounds q * scale * log2(e), the terms and P at a fixed
    offset); the all-underflow row is exactly 0 in all four. Measured on
    these inputs: 1.1-1.3% against the fp32 arrays and the twin, 3.7-5.9%
    against the bf16 arrays (the twin 3.4-5.6%)."""
    heads, hw = 2, (14, 14)
    q, k, v, rel = _k12q8_inputs(14, d, heads)
    inv = np.full((1,), 80.0, np.float32)
    got = tsam.grouped_window_attention_relpos_v2_q8_tc_torch(
        *_t(q, k, v, rel, inv), hw, heads)
    plain = tsam.grouped_window_attention_relpos_v2_q8_torch(
        *_t(q, k, v, rel, inv), hw, heads)
    want, want_bf16 = (np.asarray(jsam.grouped_window_attention_relpos_v2_q8(
        *(jnp.asarray(x, dt) for x in (q, k, v, rel)), jnp.asarray(inv), hw,
        num_heads=heads)) for dt in (jnp.float32, jnp.bfloat16))
    assert got.dtype == torch.int8 and got.shape == plain.shape == want.shape
    assert np.abs(want).max() == 127
    for out in (got.numpy(), plain.numpy(), want, want_bf16):
        assert np.all(out[0, 0] == 0)
    for ref in (plain.numpy(), want):
        most, share = _lsb(got.numpy(), ref)
        assert most <= 1 and share <= K1Q_SHARE, (most, share)
    most, share = _lsb(got.numpy(), want_bf16)
    assert most <= 1 and share <= K1Q_BF16_SHARE, (most, share)


@pytest.mark.parametrize("win", [14, 5])
def test_v2_q8_tc_model_is_k1q_on_split_inputs(win):
    """K12q8's and K1q's tensor-core models are one function: on the same
    values the split form equals `grouped_window_attention_relpos_v3_tc_
    torch(cat([q, k, v], -1), ..., inv_scale=)` bit for bit, on fp32 and on
    bf16 tensors."""
    heads, hw = 2, (win, win)
    q, k, v, rel = _t(*_k12q8_inputs(win, 80, heads))
    inv = torch.full((1,), 80.0)
    for dt in (torch.float32, torch.bfloat16):
        args = [x.to(dt) for x in (q, k, v, rel)]
        split = tsam.grouped_window_attention_relpos_v2_q8_tc_torch(
            *args, inv, hw, heads)
        fused = tsam.grouped_window_attention_relpos_v3_tc_torch(
            torch.cat(args[:3], -1), args[3], hw, heads, inv_scale=inv)
        assert split.dtype == fused.dtype == torch.int8
        assert torch.equal(split, fused)


def test_v2_all_underflow_row_is_zero():
    """K1's EXP2_SHIFT contract on the split inputs: a row whose logits all
    lie far below EXP2_SHIFT - 126 (log2 units) comes out as 0."""
    q, k, v, rel_h, rel_w, hw = _setup(3, b=2, nh=2, d=8)
    k[0] = 1.0
    q[0, 0] = -60.0
    raw = [_flat(x) for x in (q, k, v)]
    rel = _packed(q, rel_h, rel_w, hw, 2)
    rel[0, 0] = 0.0
    got = tsam.grouped_window_attention_relpos_v2(*_t(*raw, rel), hw, 2)
    assert torch.all(got[0, 0] == 0) and got[0, 1].abs().max() > 0


def test_sam_window_attention_raw_matches_jax_forward_and_vjp():
    q, k, v, rel_h, rel_w, hw = _setup(4, b=3, nh=2, d=8)
    raw = [_flat(x) for x in (q, k, v)]
    nh = 2
    g = np.random.default_rng(5).normal(size=raw[0].shape).astype(
        np.float32)
    want, vjp = jax.vjp(lambda *a: jsam.sam_window_attention_raw(*a, hw, nh),
                        *_j(*raw, rel_h, rel_w))
    leaves = [t.requires_grad_() for t in _t(*raw, rel_h, rel_w)]
    got = tsam.sam_window_attention_raw(*leaves, hw, nh)
    _close(got.detach(), want)
    _grads_close(torch.autograd.grad(got, leaves, torch.from_numpy(g)),
                 vjp(jnp.asarray(g)))


# ---------------------------------------------------------------------------
# K13: the bias-folded experiments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["heads", "raw"])
def test_folded_window_attention_matches_jax(layout):
    q, k, v, rel_h, rel_w, hw = _setup(6, b=3)
    b, s, nh, d = q.shape
    rh, rw = _terms(q, rel_h, rel_w, hw)
    if layout == "heads":
        want = jsam.folded_window_attention_relpos(*_j(q, k, v, rh, rw), hw,
                                                   group=4)
        got = tsam.folded_window_attention_relpos(*_t(q, k, v, rh, rw), hw)
    else:
        raw = [_flat(x) for x in (q, k, v)]
        want = jsam.folded_window_attention_relpos_v2(
            *_j(*raw, rh, rw), hw, num_heads=nh, group=3)
        got = tsam.folded_window_attention_relpos_v2(*_t(*raw, rh, rw), hw,
                                                     nh)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


# ---------------------------------------------------------------------------
# K11: the streamed flash form and its torch-ops VJP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,block", [(16, 64), (16, 256), (14, 28)])
def test_flash_attention_relpos_matches_jax(g, block):
    q, k, v, rel_h, rel_w, hw = _setup(7, b=1, g=g, nh=2, d=8)
    rh, rw = _terms(q, rel_h, rel_w, hw)
    want = jsam.flash_attention_relpos(*_j(q, k, v, rh, rw), hw,
                                       block_q=block, block_k=block)
    got = tsam.flash_attention_relpos(*_t(q, k, v, rh, rw), hw,
                                      block_q=block, block_k=block)
    _close(got, want)


@pytest.mark.parametrize("g", [16, 14])
def test_fused_with_vjp_matches_jax(g):
    """`_fused_with_vjp`: forward through K11 with JAX's block choice, the
    per-sample torch-ops backward against `jax.vjp` of the JAX one."""
    q, k, v, rel_h, rel_w, hw = _setup(8, b=2, g=g, nh=2, d=8)
    gout = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jsam._fused_with_vjp(*a, hw),
                        *_j(q, k, v, rel_h, rel_w))
    leaves = [t.requires_grad_() for t in _t(q, k, v, rel_h, rel_w)]
    got = tsam._fused_with_vjp(*leaves, hw)
    _close(got.detach(), want)
    _grads_close(torch.autograd.grad(got, leaves, torch.from_numpy(gout)),
                 vjp(jnp.asarray(gout)))


@pytest.mark.parametrize("block_q,block_k", [(64, 48), (96, 64), (256, 8)])
def test_flash_attention_relpos_raises_where_jax_asserts(block_q, block_k):
    q, k, v, rel_h, rel_w, hw = _setup(10, b=1, g=16, nh=2, d=8)
    rh, rw = _terms(q, rel_h, rel_w, hw)
    with pytest.raises(AssertionError):
        jsam.flash_attention_relpos(*_j(q, k, v, rh, rw), hw,
                                    block_q=block_q, block_k=block_k)
    with pytest.raises(ValueError, match="block"):
        tsam.flash_attention_relpos(*_t(q, k, v, rh, rw), hw,
                                    block_q=block_q, block_k=block_k)


def test_shape_checks_raise():
    q, k, v, rel_h, rel_w, hw = _setup(11, b=2, nh=2, d=8)
    rh, rw = _terms(q, rel_h, rel_w, hw)
    tq, tk, tv, trh, trw = _t(q, k, v, rh, rw)
    with pytest.raises(ValueError, match="do not match"):
        tsam.folded_window_attention_relpos(tq, tk, tv, trh, trw, (14, 15))
    with pytest.raises(ValueError, match="rel terms"):
        tsam.flash_attention_relpos(tq, tk, tv, trh[:1], trw, hw, 28, 28)
    raw = _t(*(_flat(x) for x in (q, k, v)))
    with pytest.raises(ValueError, match="rel"):
        tsam.grouped_window_attention_relpos_v2(*raw, raw[0][..., :10], hw,
                                                2)


def test_new_ops_launch_nothing_on_the_cpu():
    _kernels.reset_launch_counts()
    test_folded_window_attention_matches_jax("raw")
    test_flash_attention_relpos_matches_jax(14, 28)
    test_v2_window_attention_matches_jax(2, 2, 16)
    test_partition_matches_jax("float32", (2, 10, 10, 8))
    assert all(k.launches == 0 for k in _kernels.KERNELS.values())


# ---------------------------------------------------------------------------
# K14: window partition / unpartition
# ---------------------------------------------------------------------------

def _grid(dtype, shape, seed=12):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return rng.integers(-127, 128, size=shape).astype(np.int8)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype,shape", [("float32", (2, 10, 10, 8)),
                                         ("int8", (2, 10, 10, 8)),
                                         ("float32", (1, 8, 8, 16)),
                                         ("int8", (1, 7, 9, 3))])
def test_partition_matches_jax(dtype, shape):
    x = _grid(dtype, shape)
    want = np.asarray(jwin.window_partition_fused(jnp.asarray(x), 4))
    got = twin.window_partition_fused(torch.from_numpy(x), 4).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,shape", [("float32", (2, 10, 10, 8)),
                                         ("int8", (1, 7, 9, 3))])
def test_unpartition_matches_jax_and_inverts(dtype, shape):
    x = _grid(dtype, shape, seed=13)
    hw = shape[1:3]
    wins = np.array(jwin.window_partition_fused(jnp.asarray(x), 4))
    want = np.asarray(jwin.window_unpartition_fused(jnp.asarray(wins), 4,
                                                    hw))
    got = twin.window_unpartition_fused(_t(wins)[0], 4, hw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x)


def test_window_ops_gradients_are_each_others_copies():
    """Each direction's backward is the other direction (JAX's custom
    VJPs), on a grid that needs a pad: against `jax.vjp`."""
    x = _grid("float32", (2, 6, 7, 4), seed=14)
    wins = np.array(jwin.window_partition_fused(jnp.asarray(x), 4))
    rng = np.random.default_rng(15)
    gp = rng.normal(size=wins.shape).astype(np.float32)
    gu = rng.normal(size=x.shape).astype(np.float32)
    _, vjp_p = jax.vjp(lambda a: jwin.window_partition_fused(a, 4),
                       jnp.asarray(x))
    _, vjp_u = jax.vjp(lambda a: jwin.window_unpartition_fused(a, 4, (6, 7)),
                       jnp.asarray(wins))
    tx = torch.from_numpy(x).requires_grad_()
    tw = _t(wins)[0].requires_grad_()
    (dx,) = torch.autograd.grad(twin.window_partition_fused(tx, 4), tx,
                                torch.from_numpy(gp))
    (dw,) = torch.autograd.grad(twin.window_unpartition_fused(tw, 4, (6, 7)),
                                tw, torch.from_numpy(gu))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(vjp_p(gp)[0]))
    np.testing.assert_array_equal(dw.numpy(), np.asarray(vjp_u(gu)[0]))


def test_unpartition_rejects_windows_that_do_not_tile():
    with pytest.raises(ValueError, match="do not tile"):
        twin.window_unpartition_fused(torch.zeros(5, 4, 4, 2), 4, (10, 10))
