"""Plain versions of the port's kernels (grove_tpu_torch) == the JAX
functions that reach the Pallas kernels, run in interpret mode on the CPU.

Same numpy inputs (fixed seed) go through both; fp32, tolerance 1e-4. On the
CPU every wrapper takes its plain torch version because the tensors lie on
the CPU; the CUDA kernels themselves are checked on the card by
`chip_smoke.py` (this file imports jax, which the card's machine lacks).
"""

import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import attention as jattn  # noqa: E402
from grove_tpu.ops import flash_backward as jflash  # noqa: E402
from grove_tpu.ops import sam_attention as jsam  # noqa: E402
from grove_tpu_torch import _kernels  # noqa: E402
from grove_tpu_torch.ops import attention as tattn  # noqa: E402
from grove_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from grove_tpu_torch.ops import int4_matmul as tint4  # noqa: E402
from grove_tpu_torch.ops import flash_backward as tflash  # noqa: E402
from grove_tpu_torch.ops import sam_attention as tsam  # noqa: E402

TOL = 1e-4


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("nw,win,heads,d", [(3, 14, 2, 8), (2, 4, 3, 16)])
def test_k1_window_attention_matches_pallas(nw, win, heads, d):
    """K1 plain == `sam_window_attention_fused` (v3 Pallas kernel,
    interpret mode), unsplit qkv in, through the rel-term glue."""
    rng = np.random.default_rng(0)
    s, c = win * win, heads * d
    qkv = _randn(rng, nw, s, 3 * c)
    rh = _randn(rng, 2 * win - 1, d) * 0.3
    rw = _randn(rng, 2 * win - 1, d) * 0.3
    want = jsam.sam_window_attention_fused(jnp.asarray(qkv), jnp.asarray(rh),
                                           jnp.asarray(rw), (win, win),
                                           heads)
    got = tsam.sam_window_attention_fused(_t(qkv), _t(rh), _t(rw),
                                          (win, win), heads)
    _close(got, want)


def test_k1_all_underflow_row_is_zero():
    """K1's contract from the TPU kernel's constant exp2 shift
    (`sam_attention.py:29-39`): row 0 of window 0 has every logit near -300
    in log2 units, so the Pallas kernel (interpret mode) returns zeros
    there, and so does the port's plain K1; every other row matches."""
    rng = np.random.default_rng(7)
    nw, win, heads, d = 2, 4, 2, 8
    s, c = win * win, heads * d
    qkv = _randn(rng, nw, s, 3 * c)
    kk = np.ones(d, np.float32)
    for h in range(heads):
        qkv[0, :, c + h * d:c + (h + 1) * d] = (
            kk + 0.3 * _randn(rng, s, d))
        qkv[0, 0, h * d:(h + 1) * d] = -73.0 * kk
    rh = _randn(rng, 2 * win - 1, d) * 0.01
    rw = _randn(rng, 2 * win - 1, d) * 0.01
    want = np.asarray(jsam.sam_window_attention_fused(
        jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), (win, win),
        heads))
    got = tsam.sam_window_attention_fused(_t(qkv), _t(rh), _t(rw),
                                          (win, win), heads).numpy()
    assert np.all(want[0, 0] == 0) and np.all(got[0, 0] == 0)
    assert np.all(np.abs(got[0, 1:]) > 0)
    _close(got, want)


def test_k1_rel_terms_raw_match():
    rng = np.random.default_rng(1)
    win, heads, d = 6, 2, 8
    q = _randn(rng, 3, win * win, heads * d)
    rh, rw = _randn(rng, 2 * win - 1, d), _randn(rng, 2 * win - 1, d)
    want = jsam.relpos_terms_raw(jnp.asarray(q), jnp.asarray(rh),
                                 jnp.asarray(rw), (win, win), heads)
    got = tsam.relpos_terms_raw(_t(q), _t(rh), _t(rw), (win, win), heads)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("b,g,heads,d", [(2, 8, 2, 8), (1, 6, 4, 16)])
def test_k2_global_attention_matches_pallas(b, g, heads, d):
    """K2 plain == `grouped_window_attention_relpos` (Pallas, interpret
    mode) on the terms of `relpos_terms`; and the model-facing
    `sam_attention_with_relpos` == the JAX one."""
    rng = np.random.default_rng(2)
    s = g * g
    q, k, v = (_randn(rng, b, s, heads, d) for _ in range(3))
    rh = _randn(rng, 2 * g - 1, d) * 0.3
    rw = _randn(rng, 2 * g - 1, d) * 0.3
    jrh, jrw = jsam.relpos_terms(jnp.asarray(q), jnp.asarray(rh),
                                 jnp.asarray(rw), (g, g))
    trh, trw = tsam.relpos_terms(_t(q), _t(rh), _t(rw), (g, g))
    _close(trh, jrh, 1e-5)
    _close(trw, jrw, 1e-5)
    want = jsam.grouped_window_attention_relpos(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jrh, jrw, (g, g),
        group=4)
    got = tsam.grouped_window_attention_relpos(
        _t(q), _t(k), _t(v), _t(np.asarray(jrh)), _t(np.asarray(jrw)),
        (g, g))
    _close(got, want)
    want2 = jsam.sam_attention_with_relpos(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(rh),
        jnp.asarray(rw), (g, g))
    got2 = tsam.sam_attention_with_relpos(_t(q), _t(k), _t(v), _t(rh),
                                          _t(rw), (g, g))
    _close(got2, want2)


@pytest.mark.parametrize("b,s,heads,d", [(2, 37, 2, 8), (1, 20, 3, 64)])
def test_k3_grouped_plain_matches_pallas(b, s, heads, d):
    """K3 plain == `grouped_plain_attention` (Pallas, interpret mode) at a
    ragged S, and `multi_head_attention(_impl="grouped")` routes there."""
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, b, s, heads, d) for _ in range(3))
    want = jattn.grouped_plain_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    _close(tattn.grouped_plain_attention(_t(q), _t(k), _t(v)), want)
    _close(tattn.multi_head_attention(_t(q), _t(k), _t(v), _impl="grouped"),
           want)


@pytest.mark.parametrize("causal", [True, False])
def test_k4_flash_forward_lse_matches_pallas(causal):
    """K4 plain == `flash_forward_lse` (Pallas, interpret mode): the output,
    and the LSE after reshaping the JAX (B*H, n_blk, block) layout to
    (B, H, S)."""
    rng = np.random.default_rng(4)
    b, s, heads, d, block = 2, 128, 2, 8, 64
    q, k, v = (_randn(rng, b, s, heads, d) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    jout, jlse = jflash.flash_forward_lse(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal,
                                          scale=scale, block=block)
    out, lse = tflash.flash_forward_lse(_t(q), _t(k), _t(v), causal=causal,
                                        scale=scale)
    _close(out, jout)
    _close(lse, np.asarray(jlse).reshape(b, heads, s))


def test_k4_is_the_causal_multi_head_path():
    """At S = 128, a multiple of 64 and at least 128, the causal "auto"
    route is K4 with K4b behind it."""
    assert tattn.attention_route(128, 128, 8, True, True) == \
        "flash_forward_lse"
    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, 1, 128, 2, 8) for _ in range(3))
    want = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True)
    _close(tattn.multi_head_attention(_t(q), _t(k), _t(v), causal=True),
           want)


def test_xla_attention_with_mask_and_bias_matches():
    rng = np.random.default_rng(6)
    q, k, v = (_randn(rng, 2, 9, 2, 8) for _ in range(3))
    bias = _randn(rng, 2, 2, 9, 9)
    mask = rng.random((2, 1, 9, 9)) > 0.3
    mask[..., 0] = True
    want = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), bias=jnp.asarray(bias),
                               mask=jnp.asarray(mask))
    got = tattn.xla_attention(_t(q), _t(k), _t(v), bias=_t(bias),
                              mask=_t(mask))
    _close(got, want)


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; anything but
    CPU or CUDA raises instead of falling back."""
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tattn.grouped_plain_attention(q, q, q)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tflash.flash_forward_lse(q, q, q, causal=True, scale=1.0)
    x = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tint4.int4_matmul(x, torch.zeros(32, 8, dtype=torch.int8,
                                         device="meta"),
                          torch.ones(2, 8, device="meta"))


def test_launch_counts_untouched_by_plain_path():
    _kernels.reset_launch_counts()
    x = torch.zeros(1, 4, 2, 8)
    tattn.grouped_plain_attention(x, x, x)
    tflash.flash_forward_lse(x, x, x, causal=True, scale=1.0)
    tattn.prefill_attention_raw(x.reshape(1, 4, 16), x.reshape(1, 4, 16),
                                x.reshape(1, 4, 16),
                                torch.zeros(1, dtype=torch.long), 2, 1.0)
    kt = torch.zeros(1, 2, 128, 8, dtype=torch.int8)
    sc = torch.ones(1, 2, 128, dtype=torch.bfloat16)
    tdec.int8_cache_decode_attention(x[:, 0], kt, kt, sc, sc,
                                     torch.zeros(1, 128))
    tint4.int4_matmul(torch.zeros(2, 64), torch.zeros(32, 8,
                                                      dtype=torch.int8),
                      torch.ones(2, 8))
    tattn.flash_attention(x, x, x, causal=True)
    assert all(k.launches == 0 for k in _kernels.KERNELS.values())
    assert {k.source.split("/")[-1] for k in _kernels.KERNELS.values()} == {
        p.name for p in _kernels.sources() if p.name != "errors.cu"}
    # K1, K1q, K2, K3, K4, K4b's dq and dkv, K5, K9's forward, dq and dkv,
    # K10, K11, K12, K12q8 and K13 (v1 and v2) each have a tensor-core entry
    # beside the SIMT one: the same source file, TPU kernel and arguments,
    # the symbol `_tc`
    tc = {n: k for n, k in _kernels.KERNELS.items() if n.endswith("_tc")}
    assert sorted(tc) == ["flash_attention_relpos_tc", "flash_attention_tc",
                          "flash_backward_dkv_tc", "flash_backward_dq_tc",
                          "flash_forward_lse_tc",
                          "folded_window_attention_tc",
                          "folded_window_attention_v2_tc",
                          "grouped_plain_attention_tc",
                          "prefill_attention_tc",
                          "relpos_flash_dkv_tc", "relpos_flash_dq_tc",
                          "relpos_flash_fwd_lse_tc",
                          "sam_global_attention_tc",
                          "sam_window_attention_q8_tc",
                          "sam_window_attention_tc",
                          "sam_window_attention_v2_q8_tc",
                          "sam_window_attention_v2_tc"]
    for name, k in tc.items():
        simt = _kernels.KERNELS[name.removesuffix("_tc")]
        assert (k.source, k.replaces, k.argtypes) == (
            simt.source, simt.replaces, simt.argtypes)
        assert k.symbol == simt.symbol + "_tc"
        assert f"extern \"C\" int {k.symbol}(" in (
            _kernels.CSRC.parent.parent / k.source).read_text()
    assert tc["flash_attention_tc"].replaces == "grove_tpu/ops/attention.py:154"
    assert tc["grouped_plain_attention_tc"].replaces == \
        "grove_tpu/ops/attention.py:404"
    assert tc["flash_forward_lse_tc"].replaces == \
        "grove_tpu/ops/flash_backward.py:210"
    assert tc["sam_global_attention_tc"].replaces == \
        "grove_tpu/ops/sam_attention.py:235"
    for name in ("sam_window_attention_tc", "sam_window_attention_q8_tc"):
        assert tc[name].replaces == "grove_tpu/ops/sam_attention.py:537"
        assert tc[name].source == \
            "grove_tpu_torch/csrc/sam_window_attention.cu"
    assert tc["relpos_flash_fwd_lse_tc"].replaces == \
        "grove_tpu/ops/sam_attention_bwd.py:243"
    assert tc["relpos_flash_fwd_lse_tc"].source == \
        "grove_tpu_torch/csrc/relpos_flash_attention.cu"
    assert tc["sam_window_attention_v2_tc"].replaces == \
        "grove_tpu/ops/sam_attention.py:598"
    assert tc["folded_window_attention_v2_tc"].replaces == \
        "grove_tpu/ops/sam_attention.py:818"
    # the int8 entry takes the inverse scale before the output, as K1q's
    # SIMT one does
    assert tc["sam_window_attention_q8_tc"].argtypes[:4] == (
        ctypes.c_void_p,) * 4
    assert _kernels.TC_HEAD_DIMS == (64, 80, 128)
    assert (_kernels.CSRC / "attention_tc.cuh").is_file()


def test_build_reports_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    if _kernels.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
