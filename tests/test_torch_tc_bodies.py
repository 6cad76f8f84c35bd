"""K5 on the tensor-core forward body and K9's dkv on the tensor-core
backward body, on the CPU, small sizes.

* The routes: a CUDA call of K5 (`prefill_attention_raw`, and through it
  `prefill_attention_trainable`) and of K9's dkv (`relpos_flash_dkv`) takes
  the `_tc` entry for bf16 at head dim 64, 80 or 128 and the SIMT entry
  for fp32 and the head dim 8 (`ops.attention._tc_takes`); K9's dkv on
  an odd grid (term tables not 16-byte aligned per (batch, head)) the SIMT
  entry too.
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
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import attention as jattn  # noqa: E402
from grove_tpu.ops import sam_attention_bwd as jrel  # noqa: E402
from grove_tpu_torch.ops import attention as tattn  # noqa: E402
from grove_tpu_torch.ops import sam_attention_bwd as trel  # noqa: E402

FULL_TOL = 2e-2          # chip_smoke.py's bf16 limit, of the output's max-abs
K5_TOL = 2e-3            # K5's model vs the Pallas K5 in bf16, of max-abs
DKV_EXCESS = 5e-4        # K9 dkv's model beyond half a bf16 ULP, of max-abs


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


def _k9_case(grid, d, seed):
    """bf16 inputs of K9's backward on a grid x grid grid, the JAX forward
    and `relpos_flash_bwd` on them (Pallas, interpret mode), and the
    arguments of the port's dkv twins as fp32 tensors holding the same
    bf16 values: the terms of `relpos_terms`, the forward's LSE and D =
    rowsum(out * dO) from its bf16 out. Returns (args, (dk, dv) of JAX)."""
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
    return args, (_np(want[1]), _np(want[2]))


@pytest.mark.parametrize("grid,d", [(14, 80), (14, 128), (16, 64),
                                    (16, 80)])
def test_tc_model_k9_dkv_matches_pallas(grid, d):
    """K9's dkv on the tensor-core backward body: its model ==
    `relpos_flash_bwd`'s dk and dv (Pallas, interpret mode) on the same
    bf16 values, within half a bf16 ULP plus DKV_EXCESS of max-abs
    unrounded and within FULL_TOL after the bf16 output rounding; the SIMT
    twin, whose P and dS stay fp32, lies further off than DKV_EXCESS."""
    args, want = _k9_case(grid, d, seed=30 + grid + d)
    got = trel.relpos_flash_dkv_tc_torch(*args)
    simt = trel.relpos_flash_dkv_torch(*args)
    as_bf16 = trel.relpos_flash_dkv_tc_torch(
        *(t.to(torch.bfloat16) if torch.is_tensor(t) and t.dim() == 4
          and t.shape[-1] == d else t for t in args))
    for x, y, z, w in zip(got, simt, as_bf16, want):
        assert _excess(x, w) <= DKV_EXCESS
        assert _excess(y, w) > DKV_EXCESS
        assert z.dtype == torch.bfloat16 and _rel(z.float(), w) <= FULL_TOL
