"""K5, K11, K12 and K13 on the tensor-core forward body, and K9's and
K4b's dq and dkv on the tensor-core backward body, on the CPU, small sizes.

* The routes: a CUDA call of K5 (`prefill_attention_raw`, and through it
  `prefill_attention_trainable`), of K9's dq and dkv (`relpos_flash_dq`,
  `relpos_flash_dkv`) and of K4b's dkv (`flash_backward_dkv`, causal or
  not) takes the `_tc` entry for bf16 at head dim 64, 80 or 128 and the
  SIMT entry for fp32 and the head dim 8 (`ops.attention._tc_takes`); K9's
  dq and dkv on an odd grid (term tables not 16-byte aligned per (batch,
  head)) the SIMT entries too.
* K5: the tensor-core body's arithmetic with the left pad
  (`ops.attention.tc_attention_torch(pad=)`) against the JAX
  `prefill_attention_raw` (Pallas, interpret mode) on bf16 arrays, within
  K5_TOL of max-abs (both round P to bf16 before P.V, at other maxima),
  and against the plain twin `prefill_attention_raw_torch`
  in fp32 within FULL_TOL (the twin keeps P in fp32 there); rows inside the
  pad equal their own v row exactly.
* K9's dkv: the backward body's arithmetic
  (`ops.sam_attention_bwd.relpos_flash_dkv_tc_torch`) against dk and dv of
  the JAX `relpos_flash_bwd` (Pallas, interpret mode) on bf16 arrays, at
  SAM's windowed 14 x 14 (S = 196) and a 16 x 16 global grid (the full
  32 x 32 cut to size): its bf16 outputs within FULL_TOL, and its unrounded
  outputs within half a bf16 ULP of each Pallas output plus DKV_EXCESS of
  max-abs, since its rounding points are the TPU kernel's (P and dS to
  bf16 before the products). The SIMT twin (`relpos_flash_dkv_torch`, P
  and dS in fp32) lies beyond DKV_EXCESS, which the test also checks, so
  the tighter tolerance is the rounding points' and not slack.
* K9's dq: the same for `relpos_flash_dq_tc_torch` against the JAX
  `relpos_flash_bwd`'s dq and table gradients, the port's XLA part
  (`relpos_bias_grads`) on the twin's dq rounded to bf16 as the kernel
  writes it and its exact fp32 bucket sums d_rh, d_rw: within half a bf16
  ULP plus DQ_EXCESS of max-abs; the SIMT twin (dS in fp32) beyond it.
* K4b's dkv: here the rounding points part the other way. The TPU K4b
  keeps P and dS in fp32, which the SIMT twin (`flash_backward_dkv_torch`)
  does too, so it lies within half a bf16 ULP plus K4B_EXCESS of max-abs of
  the JAX `flash_backward`'s dk and dv (Pallas, interpret mode, bf16
  arrays, causal and not, S = 100: not a multiple of 64); the tensor-core
  model (`flash_backward_dkv_tc_torch`, P and dS in bf16 as wgmma takes
  them) lies beyond K4B_EXCESS, the recorded difference, and within
  FULL_TOL after the bf16 output rounding, each key's row within ROW_TOL
  of its own max-abs.
* K4b's dq: the same for `flash_backward_dq_tc_torch` (dS in bf16 before
  dS.K, where the TPU K4b keeps fp32) against the JAX `flash_backward`'s
  dq, each query's row within ROW_TOL of its own max-abs; a causal dq's
  first row is zero in exact arithmetic (dS_00 = P_00 (dP_00 - D_0) = 0),
  so there both carry only rounding noise, held below ZERO_ROW of the
  output's max-abs.
* K11: the forward body's arithmetic with the rel-pos bias
  (`tc_attention_torch(bias=)`, K2's) against the JAX
  `flash_attention_relpos` (Pallas, interpret mode) on bf16 arrays at a
  14 x 14 and a 4 x 8 grid, within K11_TOL of max-abs; both round P to
  bf16 before P.V, so fewer of its bf16 outputs differ from the Pallas
  ones than of the fp32 twin's (P in fp32), and where the Pallas key block
  is the body's one 64-key tile (4 x 8) all but SAME_TILE_SHARE of them
  are equal.
* The routes of K4b's dq and of K11 by dtype and head dim, as above.
* K13 v1 and v2: their model (K2's arithmetic, on the head and on the raw
  layout) against the JAX `folded_window_attention_relpos` and `_v2`
  (Pallas, interpret mode) on bf16 arrays within FULL_TOL. The TPU kernels
  round q * scale to bf16 before their contraction, the body does not (a
  recorded difference), so it is the model with that rounding added that
  sits closer to the Pallas output than the fp32 twin (at D 64, where the
  scale is a power of two, the two models are one).
* K12: its model (K1's on split q, k, v) against the plain twin and the
  JAX `grouped_window_attention_relpos_v2` within FULL_TOL, the
  all-underflow row exactly 0 in all three, and bit-equal to K1's model on
  the concatenated qkv.
* The routes of K13 v1, K13 v2 and K12 by dtype and head dim; K12q8 keeps
  its SIMT entry at every dtype.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import attention as jattn  # noqa: E402
from grove_tpu.ops import flash_backward as jflash  # noqa: E402
from grove_tpu.ops import sam_attention as jsam  # noqa: E402
from grove_tpu.ops import sam_attention_bwd as jrel  # noqa: E402
from grove_tpu_torch.ops import attention as tattn  # noqa: E402
from grove_tpu_torch.ops import flash_backward as tflash  # noqa: E402
from grove_tpu_torch.ops import sam_attention as tsam  # noqa: E402
from grove_tpu_torch.ops import sam_attention_bwd as trel  # noqa: E402
from test_torch_flash import _k1_inputs, _t, _within  # noqa: E402

FULL_TOL = 2e-2          # chip_smoke.py's bf16 limit, of the output's max-abs
ROW_TOL = 1e-2           # chip_smoke.py's row limit, of each row's max-abs
K5_TOL = 2e-3            # K5's model vs the Pallas K5 in bf16, of max-abs
DKV_EXCESS = 5e-4        # K9 dkv's model beyond half a bf16 ULP, of max-abs
DQ_EXCESS = 5e-4         # K9 dq's model, the same
K4B_EXCESS = 5e-4        # K4b dkv's and dq's SIMT twins, the same
ZERO_ROW = 1e-5          # a row zero in exact arithmetic, of max-abs
K11_TOL = 2.0 ** -7      # K11's model vs the Pallas K11 in bf16, of max-abs:
                         # one bf16 ULP at the max-abs, P rounded at other maxima
SAME_TILE_SHARE = 1e-2   # K11's bf16 outputs off the Pallas ones, one tile


def _bf16(rng, *shape):
    """Normal samples as a bf16 tensor."""
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = (torch.from_numpy(np.array(x, np.float32))
                 for x in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def _row_share(got, want):
    """The largest distance of a row (the last axis) of `got` from `want`,
    of that row's own max-abs in `want`."""
    got, want = (torch.from_numpy(np.array(x, np.float32))
                 for x in (got, want))
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1).clamp_min(1e-30)).max())


def _excess(got, want):
    """How far `got` lies from the bf16 `want` beyond half of want's ULP
    (at most 2^-8 |want|), of want's max-abs."""
    got, want = (torch.from_numpy(np.array(x, np.float32))
                 for x in (got, want))
    over = ((got - want).abs() - 2.0 ** -8 * want.abs()).clamp_min(0)
    return float(over.max() / want.abs().max())


@pytest.mark.parametrize("dtype,head_dim,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 80, True),
    (torch.bfloat16, 128, True), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.bfloat16, 8, False)])
def test_k5_and_k9_dkv_route_by_dtype_and_head_dim(monkeypatch, dtype,
                                                   head_dim, tc):
    """bf16 at head dim 64, 80 or 128 launches the `_tc` entries of K5 and
    K9's dkv; fp32 and the head dim 8 their SIMT entries. The wrappers are
    driven past `on_cpu` with the launches recorded by name."""
    launched = []
    monkeypatch.setattr(tattn._kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(tattn, "_prefill_launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(trel, "_dkv_launch",
                        lambda name, *a: launched.append(name))
    raw = torch.zeros(2, 128, 2 * head_dim, dtype=dtype)
    pad = torch.zeros(2, dtype=torch.int32)
    tattn.prefill_attention_raw(raw, raw, raw, pad, 2, 1.0)
    tattn.prefill_attention_trainable(raw, raw, raw, 2, 1.0)
    x = torch.zeros(1, 64, 2, head_dim, dtype=dtype)
    rel = torch.zeros(1, 2, 64, 8, dtype=dtype)
    stat = torch.zeros(1, 2, 64)
    trel.relpos_flash_dkv(x, x, x, rel, rel, x, stat, stat, (8, 8), 1.0)
    suffix = "_tc" if tc else ""
    assert launched == [n + suffix for n in (
        "prefill_attention", "prefill_attention", "relpos_flash_dkv")]


@pytest.mark.parametrize("grid,tc", [(2, True), (7, False), (8, True),
                                     (14, True), (16, True), (32, True)])
def test_k9_dkv_routes_by_term_table_alignment(monkeypatch, grid, tc):
    """bf16 K9 dkv takes the `_tc` entry only where each (batch, head)
    block of the term tables starts 16-byte aligned (S g a multiple of 8),
    as its 16-byte copies need: every grid of SAM's configurations, not an
    odd one such as 7 x 7, which takes the SIMT entry."""
    launched = []
    monkeypatch.setattr(tattn._kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(trel, "_dkv_launch",
                        lambda name, *a: launched.append(name))
    s = grid * grid
    x = torch.zeros(1, s, 2, 64, dtype=torch.bfloat16)
    rel = torch.zeros(1, 2, s, grid, dtype=torch.bfloat16)
    stat = torch.zeros(1, 2, s)
    trel.relpos_flash_dkv(x, x, x, rel, rel, x, stat, stat, (grid, grid),
                          1.0)
    assert launched == ["relpos_flash_dkv" + ("_tc" if tc else "")]


# (b, s, heads, d, pads): LLaMA's pad 37 inside the first key tile with a
# ragged last tile; a pad of 130 covering two whole 64-key tiles; a pad
# past the middle at D = 80; rows inside the pad in every case
K5_CASES = {
    "pads 0, 37, S=160, D=64": (2, 160, 2, 64, (0, 37)),
    "pads 0, 130 (whole tiles), D=128": (2, 200, 2, 128, (0, 130)),
    "pad 70, S=136, D=80": (1, 136, 2, 80, (70,)),
}


@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_tc_model_k5_matches_pallas_and_plain(name):
    """K5's tensor-core model with the pad == the JAX
    `prefill_attention_raw` (Pallas, interpret mode) on the same bf16
    arrays within K5_TOL, == `prefill_attention_raw_torch` in fp32 within
    FULL_TOL, and each row inside the pad is its own v row, exactly."""
    b, s, h, d, pads = K5_CASES[name]
    rng = np.random.default_rng(20)
    q, k, v = (_bf16(rng, b, s, h * d) for _ in range(3))
    pad = torch.tensor(pads, dtype=torch.int32)
    scale = d ** -0.5
    heads = [t.view(b, s, h, d) for t in (q, k, v)]
    got = tattn.tc_attention_torch(*heads, scale=scale, causal=True,
                                   pad=pad).reshape(b, s, h * d)
    want = _np(jattn.prefill_attention_raw(
        *(_jax(t) for t in (q, k, v)), jnp.asarray(pads, jnp.int32), h,
        scale))
    assert _rel(got.to(torch.bfloat16).float(), want) <= K5_TOL

    f32 = [t.float() for t in (q, k, v)]
    got32 = tattn.tc_attention_torch(
        *(t.view(b, s, h, d) for t in f32), scale=scale, causal=True,
        pad=pad).reshape(b, s, h * d)
    plain = tattn.prefill_attention_raw_torch(*f32, pad, h, scale)
    assert _rel(got32, plain) <= FULL_TOL
    # the wrapper takes the plain twin for CPU tensors
    torch.testing.assert_close(
        tattn.prefill_attention_raw(*f32, pad, h, scale), plain)
    for i, p in enumerate(pads):
        torch.testing.assert_close(got32[i, :p], f32[2][i, :p], rtol=0,
                                   atol=0)
        assert p < s and bool(torch.isfinite(got32).all())


@functools.lru_cache(maxsize=None)
def _k9_case(grid, d, seed):
    """bf16 inputs of K9's backward on a grid x grid grid, the JAX forward
    and `relpos_flash_bwd` on them (Pallas, interpret mode), and the
    arguments of the port's dq and dkv twins as fp32 tensors holding the
    same bf16 values: the terms of `relpos_terms`, the forward's LSE and D
    = rowsum(out * dO) from its bf16 out. Returns (args, the rel-pos
    tables as fp32 tensors, (dq, dk, dv, dRh, dRw) of JAX)."""
    b, h = 2, 2
    s, hw = grid * grid, (grid, grid)
    rng = np.random.default_rng(seed)
    q, k, v, g = (_bf16(rng, b, s, h, d) for _ in range(4))
    tables = [(torch.from_numpy(rng.normal(size=(2 * grid - 1, d))
                                .astype(np.float32)) * 0.3)
              .to(torch.bfloat16) for _ in range(2)]
    jx = [_jax(t) for t in (q, k, v, *tables)]
    scale = 1.0 / math.sqrt(d)
    jrh, jrw = jrel.relpos_terms(jx[0], jx[3], jx[4], hw)
    jout, jlse = jrel.relpos_flash_fwd_lse(*jx[:3], jrh, jrw, hw, scale)
    want = jrel.relpos_flash_bwd(*jx, jout, jlse, _jax(g), hw, scale)
    rh, rw, out = (torch.from_numpy(_np(x)) for x in (jrh, jrw, jout))
    lse = torch.from_numpy(np.asarray(jlse)).reshape(b, h, s)
    dcap = (out * g.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q.float(), k.float(), v.float(), rh, rw, g.float(), lse, dcap,
            hw, scale)
    return args, tuple(t.float() for t in tables), tuple(_np(w) for w in want)


@pytest.mark.parametrize("grid,d", [(14, 80), (14, 128), (16, 64),
                                    (16, 80)])
def test_tc_model_k9_dkv_matches_pallas(grid, d):
    """K9's dkv on the tensor-core backward body: its model ==
    `relpos_flash_bwd`'s dk and dv (Pallas, interpret mode) on the same
    bf16 values, within half a bf16 ULP plus DKV_EXCESS of max-abs
    unrounded and within FULL_TOL after the bf16 output rounding; the SIMT
    twin, whose P and dS stay fp32, lies further off than DKV_EXCESS."""
    args, _, want = _k9_case(grid, d, seed=30 + grid + d)
    want = want[1:3]
    got = trel.relpos_flash_dkv_tc_torch(*args)
    simt = trel.relpos_flash_dkv_torch(*args)
    as_bf16 = trel.relpos_flash_dkv_tc_torch(
        *(t.to(torch.bfloat16) if torch.is_tensor(t) and t.dim() == 4
          and t.shape[-1] == d else t for t in args))
    for x, y, z, w in zip(got, simt, as_bf16, want):
        assert _excess(x, w) <= DKV_EXCESS
        assert _excess(y, w) > DKV_EXCESS
        assert z.dtype == torch.bfloat16 and _rel(z.float(), w) <= FULL_TOL


@pytest.mark.parametrize("grid,d", [(14, 80), (14, 128), (16, 64),
                                    (16, 80)])
def test_tc_model_k9_dq_matches_pallas(grid, d):
    """K9's dq on the tensor-core backward body: its model's dq (rounded
    to bf16, as the kernel writes it) and exact bucket sums, through the
    port's XLA part (`relpos_bias_grads`), == `relpos_flash_bwd`'s dq, dRh
    and dRw (Pallas, interpret mode) on the same bf16 values, within half a
    bf16 ULP plus DQ_EXCESS of max-abs; the SIMT twin, whose dS stays fp32,
    lies further off than DQ_EXCESS in each."""
    args, tables, want = _k9_case(grid, d, seed=30 + grid + d)
    q, hw = args[0], args[8]

    def through_xla(twin):
        dq, d_rh, d_rw = twin(*args)
        dq = dq.to(torch.bfloat16).float()
        return trel.relpos_bias_grads(q, dq, d_rh, d_rw, *tables, hw)

    got = through_xla(trel.relpos_flash_dq_tc_torch)
    simt = through_xla(trel.relpos_flash_dq_torch)
    for x, y, w in zip(got, simt, (want[0], want[3], want[4])):
        assert _excess(x, w) <= DQ_EXCESS
        assert _excess(y, w) > DQ_EXCESS


def _k4b_case(causal, d, seed):
    """bf16 inputs of K4b's backward at S = 100 (a ragged last 64-row
    tile), the JAX `flash_backward` on them (Pallas, interpret mode, P and
    dS in fp32), and the arguments of the port's twins as fp32 tensors
    holding the same bf16 values, with the forward's LSE and D from its
    bf16 out. Returns (args, (dq, dk, dv) of JAX as numpy)."""
    b, s, h = 1, 100, 2
    rng = np.random.default_rng(seed)
    q, k, v, g = (_bf16(rng, b, s, h, d) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jx = [_jax(t) for t in (q, k, v, g)]
    jout, jlse = jflash.flash_forward_lse(*jx[:3], causal=causal,
                                          scale=scale)
    want = jflash.flash_backward(*jx[:3], jout, jlse, jx[3], causal=causal,
                                 scale=scale)
    out = torch.from_numpy(_np(jout))
    lse = torch.from_numpy(np.asarray(jlse)).reshape(b, h, s)
    dcap = tflash.row_dot(out, g.float())
    args = (q.float(), k.float(), v.float(), g.float(), lse, dcap)
    return args, tuple(_np(w) for w in want)


@pytest.mark.parametrize("causal,d", [(True, 64), (True, 128),
                                      (False, 80), (False, 128)])
def test_tc_model_k4b_dkv_against_pallas(causal, d):
    """K4b's dkv at S = 100 (a ragged last 64-row tile) on bf16 arrays: the
    JAX `flash_backward`'s dk and dv (Pallas, interpret mode, P and dS in
    fp32) == the SIMT twin within half a bf16 ULP plus K4B_EXCESS of
    max-abs; the tensor-core model (P and dS to bf16 before the products)
    lies further off than K4B_EXCESS, and within FULL_TOL once its outputs
    are rounded to bf16, each key's row also within ROW_TOL of its own
    max-abs (a late key sees few queries, so its row is small beside key
    0's, which sets the max-abs)."""
    args, want = _k4b_case(causal, d, seed=40 + d + causal)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
    tc = tflash.flash_backward_dkv_tc_torch(*args, **kw)
    simt = tflash.flash_backward_dkv_torch(*args, **kw)
    as_bf16 = tflash.flash_backward_dkv_tc_torch(
        *(t.to(torch.bfloat16) for t in args[:4]), *args[4:], **kw)
    for x, y, z, w in zip(tc, simt, as_bf16, want[1:]):
        assert _excess(y, w) <= K4B_EXCESS
        assert _excess(x, w) > K4B_EXCESS
        assert z.dtype == torch.bfloat16 and _rel(z.float(), w) <= FULL_TOL
        assert _row_share(z.float(), w) <= ROW_TOL


@pytest.mark.parametrize("dtype,head_dim,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 80, True),
    (torch.bfloat16, 128, True), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.bfloat16, 8, False)])
def test_k9_dq_and_k4b_dkv_route_by_dtype_and_head_dim(monkeypatch, dtype,
                                                      head_dim, tc):
    """bf16 at head dim 64, 80 or 128 launches the `_tc` entries of K9's dq
    and of K4b's dkv (causal and not); fp32 and the head dim 8 their SIMT
    entries. The wrappers are driven past `on_cpu` with the launches
    recorded by name."""
    launched = []
    monkeypatch.setattr(tattn._kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(trel, "_dq_launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(tflash, "_dkv_launch",
                        lambda name, *a: launched.append(name))
    x = torch.zeros(1, 64, 2, head_dim, dtype=dtype)
    rel = torch.zeros(1, 2, 64, 8, dtype=dtype)
    stat = torch.zeros(1, 2, 64)
    trel.relpos_flash_dq(x, x, x, rel, rel, x, stat, stat, (8, 8), 1.0)
    for causal in (True, False):
        tflash.flash_backward_dkv(x, x, x, x, stat, stat, causal=causal,
                                  scale=1.0)
    suffix = "_tc" if tc else ""
    assert launched == [n + suffix for n in (
        "relpos_flash_dq", "flash_backward_dkv", "flash_backward_dkv")]


@pytest.mark.parametrize("grid,tc", [(2, True), (7, False), (8, True),
                                     (14, True), (16, True), (32, True)])
def test_k9_dq_routes_by_term_table_alignment(monkeypatch, grid, tc):
    """bf16 K9 dq takes the `_tc` entry only where each (batch, head) block
    of the term tables starts 16-byte aligned, as K9's dkv does (its copies
    are the same): every grid of SAM's configurations, not 7 x 7."""
    launched = []
    monkeypatch.setattr(tattn._kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(trel, "_dq_launch",
                        lambda name, *a: launched.append(name))
    s = grid * grid
    x = torch.zeros(1, s, 2, 64, dtype=torch.bfloat16)
    rel = torch.zeros(1, 2, s, grid, dtype=torch.bfloat16)
    stat = torch.zeros(1, 2, s)
    trel.relpos_flash_dq(x, x, x, rel, rel, x, stat, stat, (grid, grid), 1.0)
    assert launched == ["relpos_flash_dq" + ("_tc" if tc else "")]


@pytest.mark.parametrize("causal,d", [(True, 64), (True, 128),
                                      (False, 64), (False, 128)])
def test_tc_model_k4b_dq_against_pallas(causal, d):
    """K4b's dq at S = 100 on bf16 arrays: the JAX `flash_backward`'s dq
    (Pallas, interpret mode, dS in fp32) == the SIMT twin within half a
    bf16 ULP plus K4B_EXCESS of max-abs; the tensor-core model (dS to bf16
    before dS.K) lies further off than K4B_EXCESS, and within FULL_TOL
    once its output is rounded to bf16, each query's row within ROW_TOL of
    its own max-abs. A row whose Pallas max-abs lies below ZERO_ROW of the
    output's (causal: row 0, where dS_00 = P_00 (dP_00 - D_0) is zero in
    exact arithmetic) carries only rounding noise in both and is held below
    ZERO_ROW of the output's max-abs instead."""
    args, want = _k4b_case(causal, d, seed=50 + d + causal)
    want = want[0]
    kw = dict(causal=causal, scale=1.0 / math.sqrt(d))
    tc = tflash.flash_backward_dq_tc_torch(*args, **kw)
    simt = tflash.flash_backward_dq_torch(*args, **kw)
    as_bf16 = tflash.flash_backward_dq_tc_torch(
        *(t.to(torch.bfloat16) for t in args[:4]), *args[4:], **kw)
    assert _excess(simt, want) <= K4B_EXCESS
    assert _excess(tc, want) > K4B_EXCESS
    got = as_bf16.float()
    assert as_bf16.dtype == torch.bfloat16 and _rel(got, want) <= FULL_TOL
    w = torch.from_numpy(want)
    floor = ZERO_ROW * float(w.abs().max())
    zero = w.abs().amax(-1) < floor
    assert bool(zero[:, 0].all()) == causal and int(zero.sum()) == (
        2 if causal else 0)
    assert bool((got[zero].abs() < floor).all())
    assert _row_share(got[~zero], w[~zero]) <= ROW_TOL


@pytest.mark.parametrize("grid,d", [((14, 14), 80), ((14, 14), 128),
                                    ((4, 8), 64), ((4, 8), 80)])
def test_tc_model_k11_matches_pallas(grid, d):
    """K11 on the tensor-core forward body: its model (K2's arithmetic,
    `tc_attention_torch(bias=)`) == the JAX `flash_attention_relpos`
    (Pallas, interpret mode, its default blocks) on the same bf16 arrays
    within K11_TOL of max-abs after the bf16 output rounding; both round P
    to bf16 before P.V, so fewer of the model's bf16 outputs differ from
    the Pallas ones than of the fp32 twin's (on 14 x 14 the Pallas kernel
    takes all 196 keys as one block and the body 64-key tiles, so P is
    rounded at other maxima); on 4 x 8 (S = 32, one key tile on both
    sides) at most SAME_TILE_SHARE of them."""
    (gh, gw), b, h = grid, 2, 2
    s = gh * gw
    rng = np.random.default_rng(60 + s + d)
    q, k, v = (_bf16(rng, b, s, h, d) for _ in range(3))
    rh, rw = _bf16(rng, b, h, s, gh), _bf16(rng, b, h, s, gw)
    want = torch.from_numpy(_np(jsam.flash_attention_relpos(
        *(_jax(t) for t in (q, k, v, rh, rw)), grid)))
    got = tattn.tc_attention_torch(q, k, v, scale=d ** -0.5,
                                   bias=(rh, rw, gw)).to(torch.bfloat16)
    plain = tsam.grouped_window_attention_relpos_torch(
        *(t.float() for t in (q, k, v, rh, rw)), grid).to(torch.bfloat16)
    assert _rel(got.float(), want) <= K11_TOL
    share, share32 = ((x.float() != want).float().mean().item()
                      for x in (got, plain))
    assert share < share32
    if s <= 64:
        assert share <= SAME_TILE_SHARE < share32


@pytest.mark.parametrize("dtype,head_dim,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 80, True),
    (torch.bfloat16, 128, True), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.bfloat16, 8, False)])
def test_k4b_dq_and_k11_route_by_dtype_and_head_dim(monkeypatch, dtype,
                                                    head_dim, tc):
    """bf16 at head dim 64, 80 or 128 launches the `_tc` entries of K4b's
    dq (causal and not) and of K11; fp32 and the head dim 8 their SIMT
    entries. The wrappers are driven past `on_cpu` with the launches
    recorded by name."""
    launched = []
    monkeypatch.setattr(tattn._kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(tflash, "_dq_launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(tsam, "_launch_grid",
                        lambda name, *a: launched.append(name))
    x = torch.zeros(1, 64, 2, head_dim, dtype=dtype)
    rel = torch.zeros(1, 2, 64, 8, dtype=dtype)
    stat = torch.zeros(1, 2, 64)
    for causal in (True, False):
        tflash.flash_backward_dq(x, x, x, x, stat, stat, causal=causal,
                                 scale=1.0)
    tsam.flash_attention_relpos(x, x, x, rel, rel, (8, 8))
    suffix = "_tc" if tc else ""
    assert launched == [n + suffix for n in (
        "flash_backward_dq", "flash_backward_dq", "flash_attention_relpos")]


# ---------------------------------------------------------------------------
# K13 and K12 on the tensor-core forward body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(14, 14), (4, 8)])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("layout", ["v1", "v2"])
def test_tc_model_k13_matches_pallas(layout, grid, d):
    """K13 on the tensor-core forward body: its model (K2's arithmetic,
    `folded_window_attention_relpos_tc_torch` on v1's (B, S, H, D) layout,
    `folded_window_attention_relpos_v2_tc_torch` on v2's raw (B, S, H*D))
    == the JAX `folded_window_attention_relpos` / `_v2` (Pallas, interpret
    mode: all keys in one block) on the same bf16 arrays within FULL_TOL
    of max-abs. At D = 64 the scale 1/8 is a power of two and the model is
    the one with q * scale rounded to bf16 first (scale 1 in the body), bit
    for bit; at D = 80 and 128 it is not.

    Both TPU kernels round q * scale to bf16 before their folded
    contraction; the body scales the fp32 product (a recorded difference).
    v2 rounds the unnormalized P to bf16 before P.V and divides after, as
    the body does, so there the prescaled model is closer to the Pallas
    output than the fp32 twin (K2's plain version, P in fp32), counting the
    bf16 outputs that differ, and on 4 x 8 (one key tile on both sides) all
    but SAME_TILE_SHARE of them are equal; at D = 80 and 128 the rounding
    of q * scale alone moves 38-49% of the bf16 outputs of either twin.
    v1 normalizes P before it rounds it (a second recorded difference): the
    model and the fp32 twin each differ from it on 39-52% of the bf16
    outputs, and a plain computation with v1's two rounding points (q *
    scale and the normalized P in bf16) on all but SAME_TILE_SHARE."""
    (gh, gw), b, h = grid, 2, 2
    s = gh * gw
    rng = np.random.default_rng(70 + s + d)
    q, k, v = (_bf16(rng, b, s, h * d) for _ in range(3))
    rh, rw = _bf16(rng, b, h, s, gh), _bf16(rng, b, h, s, gw)
    q_scaled = q * torch.tensor(d ** -0.5, dtype=torch.bfloat16)
    heads = [t.reshape(b, s, h, d) for t in (q, k, v, q_scaled)]
    prescaled = tattn.tc_attention_torch(
        *heads[3:], *heads[1:3], scale=1.0,
        bias=(rh, rw, gw)).to(torch.bfloat16).reshape(q.shape)
    if layout == "v1":
        q, k, v = heads[:3]
        want = jsam.folded_window_attention_relpos(
            *(_jax(t) for t in (q, k, v, rh, rw)), grid)
        got = tsam.folded_window_attention_relpos_tc_torch(q, k, v, rh, rw,
                                                           grid)
        prescaled = prescaled.reshape(q.shape)
    else:
        want = jsam.folded_window_attention_relpos_v2(
            *(_jax(t) for t in (q, k, v, rh, rw)), grid, num_heads=h)
        got = tsam.folded_window_attention_relpos_v2_tc_torch(q, k, v, rh,
                                                              rw, grid, h)
    want = torch.from_numpy(_np(want))
    plain = tsam.grouped_window_attention_relpos_torch(
        *(t.float() for t in heads[:3]), rh.float(), rw.float(), grid)
    plain = plain.to(torch.bfloat16).reshape(q.shape)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _rel(got.float(), want) <= FULL_TOL
    assert torch.equal(got, prescaled) == (d == 64)

    def share(x):
        return (x.float() != want).float().mean().item()

    if layout == "v2":
        assert share(prescaled) < share(plain), (share(prescaled),
                                                 share(plain))
        if s <= 64:
            assert share(prescaled) <= SAME_TILE_SHARE < share(plain)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", heads[3].float(),
                              k.float()) + tsam._expand_bias(rh.float(),
                                                             rw.float())
        p = torch.softmax(logits, -1).to(torch.bfloat16).float()
        tpu = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        assert share(tpu.to(torch.bfloat16)) <= SAME_TILE_SHARE
        assert min(share(got), share(plain)) > SAME_TILE_SHARE


def _k12_inputs(win, d, heads=2, nw=2):
    """K1's inputs of `test_tc_model_k1_matches_plain_and_pallas` (bf16
    values of an unsplit qkv with an all-underflow row 0 in window 0, and
    its packed term table) with q, k and v split -> (q, k, v, rel)."""
    qkv, rel = _k1_inputs(np.random.default_rng(9), nw, win, heads, d)
    c = heads * d
    return (*(np.ascontiguousarray(qkv[..., i * c:(i + 1) * c])
              for i in range(3)), rel)


@pytest.mark.parametrize("win", [14, 5])
@pytest.mark.parametrize("d", [64, 80])
def test_tc_model_k12_matches_plain_and_pallas(win, d):
    """K12 on the tensor-core body (`grouped_window_attention_relpos_v2_
    tc_torch`, K1's model on split q, k, v) == the plain twin
    `grouped_window_attention_relpos_v2_torch` and the JAX
    `grouped_window_attention_relpos_v2` (Pallas, interpret mode, its
    EXP2_SHIFT softmax) on the same bf16 values, within FULL_TOL of max-abs;
    the all-underflow row is exactly 0 in all three. 14 x 14 is SAM's
    window (4 key tiles, the last holding 4 keys), 5 x 5 one partial
    tile."""
    heads, hw = 2, (win, win)
    q, k, v, rel = _k12_inputs(win, d, heads)
    got = tsam.grouped_window_attention_relpos_v2_tc_torch(
        *(_t(x) for x in (q, k, v, rel)), hw, heads)
    plain = tsam.grouped_window_attention_relpos_v2_torch(
        *(_t(x) for x in (q, k, v, rel)), hw, heads)
    want = np.asarray(jsam.grouped_window_attention_relpos_v2(
        *(jnp.asarray(x) for x in (q, k, v, rel)), hw, num_heads=heads))
    for out in (got.numpy(), plain.numpy(), want):
        assert np.all(out[0, 0] == 0)
        assert np.all(np.abs(out[0, 1:]).max(-1) > 0)
    _within(got, plain, rows=False)
    _within(got, want, rows=False)
    _within(plain, want, rows=False)


@pytest.mark.parametrize("win", [14, 5])
@pytest.mark.parametrize("d", [64, 80])
def test_tc_model_k12_is_k1_on_split_inputs(win, d):
    """K12's and K1's models are one function: on the same values,
    `grouped_window_attention_relpos_v2_tc_torch(q, k, v, ...)` equals
    `grouped_window_attention_relpos_v3_tc_torch(cat([q, k, v], -1), ...)`
    bit for bit, in fp32 values and on bf16 tensors."""
    heads, hw = 2, (win, win)
    q, k, v, rel = (_t(x) for x in _k12_inputs(win, d, heads))
    for dt in (torch.float32, torch.bfloat16):
        args = [x.to(dt) for x in (q, k, v, rel)]
        split = tsam.grouped_window_attention_relpos_v2_tc_torch(
            *args, hw, heads)
        fused = tsam.grouped_window_attention_relpos_v3_tc_torch(
            torch.cat(args[:3], -1), args[3], hw, heads)
        assert split.dtype == fused.dtype == dt
        assert torch.equal(split, fused)


@pytest.mark.parametrize("dtype,head_dim,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 80, True),
    (torch.bfloat16, 128, True), (torch.float32, 64, False),
    (torch.float32, 128, False), (torch.bfloat16, 8, False)])
def test_k12_and_k13_route_by_dtype_and_head_dim(monkeypatch, dtype,
                                                 head_dim, tc):
    """bf16 at head dim 64, 80 or 128 launches the `_tc` entries of K13 v2,
    K12, K12q8 and K13 v1; fp32 and the head dim 8 their SIMT entries. The
    wrappers are driven past `on_cpu` with the launches recorded by
    name."""
    launched = []
    monkeypatch.setattr(tattn._kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(tsam, "_launch_grid",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(tsam, "_split_launch",
                        lambda name, *a: launched.append(name))
    heads, hw = 2, (8, 8)
    x = torch.zeros(1, 64, heads, head_dim, dtype=dtype)
    raw = x.reshape(1, 64, heads * head_dim)
    rel = torch.zeros(1, heads, 64, 8, dtype=dtype)
    packed = torch.zeros(1, 64, heads * 16, dtype=dtype)
    tsam.folded_window_attention_relpos_v2(raw, raw, raw, rel, rel, hw, heads)
    tsam.grouped_window_attention_relpos_v2(raw, raw, raw, packed, hw, heads)
    tsam.grouped_window_attention_relpos_v2_q8(raw, raw, raw, packed,
                                               torch.ones(1), hw, heads)
    tsam.folded_window_attention_relpos(x, x, x, rel, rel, hw)
    suffix = "_tc" if tc else ""
    assert launched == ["folded_window_attention_v2" + suffix,
                        "sam_window_attention_v2" + suffix,
                        "sam_window_attention_v2_q8" + suffix,
                        "folded_window_attention" + suffix]
