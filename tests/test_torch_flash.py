"""K10 (the flash forward over ragged and cross lengths) and the JAX
package's dispatch to it, on the CPU, fp32, small sizes.

* `flash_attention_torch` and the wrapper (which takes it for CPU tensors)
  == the JAX `flash_attention` with its Pallas kernel in interpret mode,
  within 1e-4 (as `test_torch_train.py`), at several blocks and a ragged
  tail, cross lengths both ways, and the non-causal ragged route to
  `xla_attention`; the two raises and the JAX behaviours they stand for;
* float64 `gradcheck` of `_flash_with_vjp` (K10 forward, recompute
  backward);
* the route of the cache-free LLaMA pass (K4, K5, K10 or the plain path)
  == the one read from the JAX rules (`prefill_attention_ok`, `_block_for`,
  the "auto" pick of `multi_head_attention`) with the lane term dropped,
  over S = 64..2200, MHA and GQA; the model takes that route;
* `multi_head_attention`'s impl argument;
* the choice between the two CUDA entries of K1, K1q, K2, K3, K4, K9's
  forward and K10 (`_tc_takes`), and the torch model of the tensor-core
  body's arithmetic (`ops.attention.tc_attention_torch`: 64-key tiles,
  online fp32 softmax, scale after the product, the rel-pos bias after
  that in log2 units, P rounded to bf16 before P.V, the LSE from the
  running max and sum, K1's all-underflow rows, K1q's int8 epilogue)
  against the plain twins and the JAX kernels in interpret mode: K10 and
  K3, K4 with its LSE, K2 with its bias on grids whose rows a 64-key tile
  cuts anywhere, K1 and K1q on the unsplit qkv with an all-underflow row
  (K1q in LSBs, at a share measured here), K9's forward with its LSE.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import attention as jattn  # noqa: E402
from grove_tpu.ops import flash_backward as jflash  # noqa: E402
from grove_tpu.ops import sam_attention as jsam  # noqa: E402
from grove_tpu.ops import sam_attention_bwd as jrel  # noqa: E402
from grove_tpu_torch.config import LlamaConfig  # noqa: E402
from grove_tpu_torch.models import llama as tllama  # noqa: E402
from grove_tpu_torch.ops import attention as tattn  # noqa: E402
from grove_tpu_torch.ops import flash_backward as tflash  # noqa: E402
from grove_tpu_torch.ops import sam_attention as tsam  # noqa: E402
from grove_tpu_torch.ops import sam_attention_bwd as trel  # noqa: E402

TOL = 1e-4


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# (b, sq, sk, heads, d, causal, block): several blocks of 64 with a ragged
# tail; cross lengths block-aligned both ways; Sq < Sk causal (top-left
# mask); Sq > Sk causal with no key pad; the non-causal ragged keys that
# JAX hands to xla_attention
CASES = {
    "causal S=200 blocks 64": (1, 200, 200, 2, 8, True, 64),
    "non-causal Sq 64 < Sk 128": (2, 64, 128, 2, 8, False, 64),
    "non-causal Sq 192 > Sk 128": (1, 192, 128, 3, 8, False, 64),
    "causal Sq 64 < Sk 128": (2, 64, 128, 2, 8, True, 64),
    "causal Sq 128 > Sk 64": (1, 128, 64, 2, 16, True, 64),
    "non-causal ragged -> xla": (1, 200, 200, 2, 8, False, 64),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_k10_twin_matches_pallas(name):
    b, sq, sk, h, d, causal, block = CASES[name]
    rng = np.random.default_rng(0)
    q = _randn(rng, b, sq, h, d)
    k, v = _randn(rng, b, sk, h, d), _randn(rng, b, sk, h, d)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 block_q=block, block_k=block)
    kw = dict(causal=causal, block_q=block, block_k=block)
    _close(tattn.flash_attention_torch(_t(q), _t(k), _t(v), **kw), want)
    _close(tattn.flash_attention(_t(q), _t(k), _t(v), **kw), want)
    takes = tattn._flash_takes_kernel(sq, sk, causal, block)
    assert takes == (name != "non-causal ragged -> xla")


def test_k10_top_left_mask_differs_from_xla():
    """Causal Sq < Sk: the TPU kernel masks top-left (row i sees keys
    0..i), `xla_attention` bottom-right; the port follows the kernel."""
    rng = np.random.default_rng(1)
    q, k, v = (_randn(rng, 1, s, 2, 8) for s in (64, 128, 128))
    jk = jattn.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=True, block_q=64, block_k=64)
    jx = jattn.xla_attention(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=True)
    assert float(np.abs(np.asarray(jk) - np.asarray(jx)).max()) > 1e-2
    _close(tattn.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                 block_k=64), jk)


def test_k10_raises_where_jax_depends_on_its_padding():
    """Causal, Sq > Sk and a key pad: JAX's rows past Sk take the zero
    keys into their softmax, so its output changes with the block; the
    port raises. The trainable form raises for causal Sq != Sk (forward
    top-left, recompute backward bottom-right)."""
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, 1, s, 2, 8) for s in (200, 100, 100))
    jx = [np.asarray(jattn.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, block_q=64,
        block_k=bk)) for bk in (64, 128)]
    assert float(np.abs(jx[0] - jx[1]).max()) > 1e-3
    for fn in (tattn.flash_attention, tattn.flash_attention_torch):
        with pytest.raises(ValueError, match="padding"):
            fn(_t(q), _t(k), _t(v), causal=True, block_k=64)
    q2 = _t(_randn(rng, 1, 64, 2, 8))
    k2 = _t(_randn(rng, 1, 128, 2, 8))
    with pytest.raises(ValueError, match="top-left"):
        tattn._flash_with_vjp(q2, k2, k2, True)


def _f64(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape)).requires_grad_()


@pytest.mark.parametrize("causal,sq,sk", [(True, 37, 37), (False, 21, 33)])
def test_flash_with_vjp_gradcheck(causal, sq, sk):
    rng = np.random.default_rng(3)
    q, k, v = _f64(rng, 2, sq, 2, 8), _f64(rng, 2, sk, 2, 8), \
        _f64(rng, 2, sk, 2, 8)
    assert torch.autograd.gradcheck(
        lambda a, b, c: tattn._flash_with_vjp(a, b, c, causal, 0.3),
        (q, k, v))


# ---------------------------------------------------------------------------
# the route of the cache-free pass
# ---------------------------------------------------------------------------

def _jax_route(s, heads, kv_heads, masked=False):
    """The JAX package's cache-free route on the TPU (`llama.py:176-200`,
    `attention.py:454-484`) with the lane term passing (head dim 128)."""
    hd = 128
    use_raw = (kv_heads == heads
               and jattn.prefill_attention_ok((1, s, heads * hd), heads))
    if use_raw and not masked and jattn._block_for(s) is None:
        return "prefill_attention"
    big = s >= 128 and hd % 128 == 0
    if masked or not big:
        return "xla"
    return "flash_forward_lse" if jattn._block_for(s) else "flash_attention"


def _port_route(cfg, s, masked=False):
    """The port's cache-free route: K5 where `LlamaAttention` takes it (its
    own test, JAX's), else the kernel `attention_route` names for
    `multi_head_attention`."""
    if (tllama.use_raw_prefill(cfg, s) and not masked
            and tattn._block_for(s) is None):
        return "prefill_attention"
    return tattn.attention_route(s, s, cfg.head_dim, True, not masked)


@pytest.mark.parametrize("heads,kv_heads,head_dim", [(32, 32, 128),
                                                     (32, 8, 128),
                                                     (16, 16, 64),
                                                     (12, 4, 64)])
def test_cache_free_route_equals_jax(heads, kv_heads, head_dim):
    cfg = LlamaConfig(hidden_size=heads * head_dim, num_heads=heads,
                      num_kv_heads=kv_heads)
    seen = set()
    for s in range(64, 2201):
        want = _jax_route(s, heads, kv_heads)
        assert _port_route(cfg, s) == want, s
        assert _port_route(cfg, s, masked=True) == "xla"
        seen.add(want)
    assert seen == ({"prefill_attention", "flash_forward_lse",
                     "flash_attention", "xla"} if heads == kv_heads
                    else {"flash_forward_lse", "flash_attention", "xla"})
    assert _port_route(cfg, 2111) == "flash_attention"


@pytest.mark.parametrize("s", [100, 192, 200, 201])
def test_llama_takes_its_route(monkeypatch, s):
    """A small LLaMA (2 layers, head dim 8) at S tokens calls the function
    of its route in each layer, and nothing else."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tllama, "prefill_attention_trainable",
                        spy("prefill_attention",
                            tattn.prefill_attention_trainable))
    monkeypatch.setattr(tattn, "_flash_with_vjp",
                        spy("flash_attention", tattn._flash_with_vjp))
    monkeypatch.setattr(tflash, "flash_attention_trainable",
                        spy("flash_forward_lse",
                            tflash.flash_attention_trainable))
    monkeypatch.setattr(tattn, "xla_attention",
                        spy("xla", tattn.xla_attention))
    cfg = LlamaConfig.tiny()
    model = tllama.LlamaModel(cfg, dtype=torch.float32)
    x = torch.randn(1, s, cfg.hidden_size)
    model(x, torch.arange(s)[None]).sum().backward()
    route = _port_route(cfg, s)
    # the recompute backwards of K5 and K10 run xla_attention once a layer
    extra = ["xla"] if route in ("prefill_attention",
                                 "flash_attention") else []
    assert sorted(calls) == sorted([route, *extra] * cfg.num_layers)


def test_multi_head_attention_impls():
    """Each impl's function: "grouped" K3, "pallas" K4 at a block-aligned
    S and K10 otherwise, "xla"; "auto" picks as JAX does on the TPU; a
    mask with a kernel impl raises."""
    rng = np.random.default_rng(4)
    for s, causal in ((128, True), (130, True), (577, False), (130, False)):
        q, k, v = (_t(_randn(rng, 1, s, 2, 64)) for _ in range(3))
        want = tattn.xla_attention(q, k, v, causal=causal)
        for impl in ("auto", "pallas", "xla") + (("grouped",) if not causal
                                                 else ()):
            got = tattn.multi_head_attention(q, k, v, causal=causal,
                                             impl=impl)
            _close(got, want)
    qs = jnp.zeros((1, 577, 1, 64))
    assert tattn._grouped_plain_ok(577, 577, 64) == \
        jattn._grouped_plain_ok(qs, qs)
    route = tattn.attention_route
    assert route(577, 577, 64, False, True) == "grouped_plain_attention"
    assert route(130, 130, 64, True, True) == "flash_attention"
    assert route(128, 128, 64, True, True) == "flash_forward_lse"
    assert route(128, 128, 64, True, True, "xla") == "xla"
    assert route(130, 130, 64, False, True, "pallas") == "flash_attention"
    assert route(64, 128, 64, True, True, "pallas") == "flash_attention"
    assert route(100, 100, 64, True, True) == "xla"
    assert route(577, 577, 64, False, False) == "xla"
    q = _t(_randn(rng, 1, 9, 2, 8))
    with pytest.raises(ValueError, match="no bias or mask"):
        tattn.multi_head_attention(q, q, q, mask=torch.ones(9, 9).bool(),
                                   impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        tattn.multi_head_attention(q, q, q, impl="flash")


# ---------------------------------------------------------------------------
# K3 and K10: the tensor-core body (csrc/attention_tc.cuh) beside the SIMT
# one
# ---------------------------------------------------------------------------

FULL_TOL = 2e-2          # chip_smoke.py's bf16 limit, of the output's max-abs
ROW_TOL = 1e-2           # ... and K10's, of each row's own max-abs
@pytest.mark.parametrize("dtype,head_dim,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.float32, 64, False), (torch.float32, 128, False),
    (torch.bfloat16, 8, False), (torch.bfloat16, 80, True),
    (torch.float32, 80, False)])
def test_tc_takes_routes(monkeypatch, dtype, head_dim, tc):
    """bf16 at head dim 64, 80 or 128 launches the `_tc` entries of K10,
    K3, K4, K2, K1, K1q and K9's forward; fp32, and the head dim 8, the
    SIMT entries. The wrappers are driven past `on_cpu` with the launches
    recorded by name."""
    assert tattn._tc_takes(dtype, head_dim) == tc
    launched = []
    monkeypatch.setattr(tattn._kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(tattn, "_flash_launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(tattn, "_grouped_plain_launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(tflash, "_lse_launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(tsam, "_launch_grid",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(tsam, "_window_launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(trel, "_fwd_launch",
                        lambda name, *a: launched.append(name))
    x = torch.zeros(1, 64, 2, head_dim, dtype=dtype)
    tattn.flash_attention(x, x, x, causal=True)
    tattn.grouped_plain_attention(x, x, x)
    tflash.flash_forward_lse(x, x, x, causal=True, scale=1.0)
    rel = torch.zeros(1, 2, 64, 8, dtype=dtype)
    tsam.grouped_window_attention_relpos(x, x, x, rel, rel, (8, 8))
    qkv = torch.zeros(1, 64, 3 * 2 * head_dim, dtype=dtype)
    packed = torch.zeros(1, 64, 2 * 16, dtype=dtype)
    tsam.grouped_window_attention_relpos_v3(qkv, packed, (8, 8), 2)
    tsam.grouped_window_attention_relpos_v3(qkv, packed, (8, 8), 2,
                                            inv_scale=torch.ones(1))
    trel.relpos_flash_fwd_lse(x, x, x, rel, rel, (8, 8), 1.0)
    suffix = "_tc" if tc else ""
    assert launched == [n + suffix for n in (
        "flash_attention", "grouped_plain_attention", "flash_forward_lse",
        "sam_global_attention", "sam_window_attention",
        "sam_window_attention_q8", "relpos_flash_fwd_lse")]


def _bf16_values(rng, *shape):
    """Normal samples rounded to bf16, held as fp32: every path sees the
    same values."""
    x = torch.from_numpy(_randn(rng, *shape)).to(torch.bfloat16)
    return x.float().numpy()


def _within(got, want, rows: bool):
    got, want = (torch.from_numpy(np.array(x, np.float32))
                 for x in (got, want))
    err = float((got - want).abs().max())
    assert err <= FULL_TOL * float(want.abs().max()), err
    if rows:
        rel = ((got - want).abs().amax(-1)
               / want.abs().amax(-1).clamp_min(1e-30)).max()
        assert float(rel) <= ROW_TOL, float(rel)
    return err


# (b, sq, sk, heads, d, causal): causal over several tiles with a ragged
# tail, causal Sq < Sk (top-left), causal Sq > Sk with no key pad,
# non-causal cross lengths, one row
TC_K10_CASES = {
    "causal S=130": (1, 130, 130, 2, 64, True),
    "causal Sq 64 < Sk 200": (2, 64, 200, 2, 128, True),
    "causal Sq 200 > Sk 128": (1, 200, 128, 2, 64, True),
    "non-causal Sq 70 < Sk 190": (1, 70, 190, 3, 64, False),
    "causal S=1": (1, 1, 1, 2, 128, True),
}


@pytest.mark.parametrize("name", sorted(TC_K10_CASES))
def test_tc_model_k10_matches_plain_and_pallas(name):
    """The tensor-core body's arithmetic == `_flash_plain` (the K10 twin)
    and the JAX `flash_attention` (Pallas, interpret mode) from the same
    numpy inputs, within chip_smoke's bf16 limits: the bf16 P moves each
    output by about 2^-9 of its row's max-abs."""
    b, sq, sk, h, d, causal = TC_K10_CASES[name]
    rng = np.random.default_rng(5)
    q = _bf16_values(rng, b, sq, h, d)
    k, v = _bf16_values(rng, b, sk, h, d), _bf16_values(rng, b, sk, h, d)
    scale = d ** -0.5
    got = tattn.tc_attention_torch(_t(q), _t(k), _t(v), scale=scale,
                                   causal=causal)
    plain = tattn._flash_plain(_t(q), _t(k), _t(v), causal, scale)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, scale=scale)
    _close(plain, want)
    _within(got, plain, rows=True)
    _within(got, want, rows=True)


@pytest.mark.parametrize("b,s,h,d", [(1, 1, 2, 64), (2, 63, 2, 128),
                                     (1, 129, 3, 64), (1, 577, 2, 64)])
def test_tc_model_k3_matches_plain_and_pallas(b, s, h, d):
    """The tensor-core body's arithmetic, non-causal (K3) ==
    `grouped_plain_attention_torch` and the JAX `grouped_plain_attention`
    (Pallas, interpret mode) at ragged S, within FULL_TOL."""
    rng = np.random.default_rng(6)
    q, k, v = (_bf16_values(rng, b, s, h, d) for _ in range(3))
    got = tattn.tc_attention_torch(_t(q), _t(k), _t(v), scale=d ** -0.5)
    plain = tattn.grouped_plain_attention_torch(_t(q), _t(k), _t(v))
    want = jattn.grouped_plain_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    _close(plain, want)
    _within(got, plain, rows=False)
    _within(got, want, rows=False)


def _lse_within(got, want):
    """An LSE within 1e-4 of its max-abs: K4b recomputes P as
    exp(s - lse), so the LSE is held far tighter than the bf16 output."""
    got, want = (torch.from_numpy(np.array(x, np.float32))
                 for x in (got, want))
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 130, 192])
@pytest.mark.parametrize("d", [64, 128])
def test_tc_model_k4_matches_plain_and_pallas(causal, s, d):
    """K4 on the tensor-core body: the model with its LSE output ==
    `flash_forward_lse_torch` and the JAX `flash_forward_lse` (Pallas,
    interpret mode; its (B*H, n_blk, block) LSE reshaped to (B, H, S)) from
    the same bf16 values: the output within FULL_TOL and ROW_TOL, the LSE
    within 1e-4 of its max-abs."""
    b, h = 1, 2
    rng = np.random.default_rng(7)
    q, k, v = (_bf16_values(rng, b, s, h, d) for _ in range(3))
    scale = d ** -0.5
    got, got_lse = tattn.tc_attention_torch(
        _t(q), _t(k), _t(v), scale=scale, causal=causal, lse=True)
    plain, plain_lse = tflash.flash_forward_lse_torch(
        _t(q), _t(k), _t(v), causal=causal, scale=scale)
    want, want_lse = jflash.flash_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale)
    want_lse = np.asarray(want_lse).reshape(b, h, s)
    _close(plain, want)
    _close(plain_lse, want_lse)
    for ref, ref_lse in ((plain, plain_lse), (want, want_lse)):
        _within(got, ref, rows=True)
        _lse_within(got_lse, ref_lse)


@pytest.mark.parametrize("hw", [(4, 4), (8, 16), (12, 12), (14, 14)])
@pytest.mark.parametrize("d", [80, 64])
def test_tc_model_k2_matches_plain_and_pallas(hw, d):
    """K2 on the tensor-core body: the model with the decomposed bias ==
    `grouped_window_attention_relpos_torch` and the JAX
    `grouped_window_attention_relpos` (Pallas, interpret mode) on bf16
    values of `relpos_terms`' outputs, within FULL_TOL. 12 x 12 and 14 x 14
    leave a ragged last tile and a gw that does not divide 64, so a tile
    cuts grid rows anywhere."""
    b, h = 1, 2
    gh, gw = hw
    s = gh * gw
    rng = np.random.default_rng(8)
    q, k, v = (_bf16_values(rng, b, s, h, d) for _ in range(3))
    tables = [_t(_randn(rng, 2 * g - 1, d) * 0.3) for g in hw]
    rh, rw = (t.to(torch.bfloat16).float().numpy()
              for t in tsam.relpos_terms(_t(q), *tables, hw))
    got = tattn.tc_attention_torch(_t(q), _t(k), _t(v), scale=d ** -0.5,
                                   bias=(_t(rh), _t(rw), gw))
    plain = tsam.grouped_window_attention_relpos_torch(
        _t(q), _t(k), _t(v), _t(rh), _t(rw), hw)
    want = jsam.grouped_window_attention_relpos(
        *(jnp.asarray(x) for x in (q, k, v, rh, rw)), hw)
    _close(plain, want)
    _within(got, plain, rows=False)
    _within(got, want, rows=False)


# ---------------------------------------------------------------------------
# K1, K1q and K9's forward on the tensor-core body
# ---------------------------------------------------------------------------

def _k1_inputs(rng, nw, win, heads, d):
    """bf16 values of an unsplit qkv (nW, S, 3C) and of its packed term
    table (`relpos_terms_raw` on the q third, tables of scale 0.1). Row 0 of
    window 0 is an all-underflow row: its q is -73 and every k near 1, so
    its logits lie near -73 sqrt(d) log2(e), far below EXP2_SHIFT - 126
    (its rel terms, 73 times a sum of table entries, cannot lift them)."""
    s, c = win * win, heads * d
    qkv = _randn(rng, nw, s, 3 * c)
    kq = qkv[0].reshape(s, 3, heads, d)
    kq[:, 1] = 1.0 + 0.3 * _randn(rng, s, heads, d)
    kq[0, 0] = -73.0
    qkv = _t(qkv).to(torch.bfloat16).float()
    tables = [_t(_randn(rng, 2 * win - 1, d) * 0.1) for _ in range(2)]
    rel = tsam.relpos_terms_raw(qkv[..., :c], *tables, (win, win), heads)
    return qkv.numpy(), rel.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("win", [14, 5])
@pytest.mark.parametrize("d", [64, 80])
def test_tc_model_k1_matches_plain_and_pallas(win, d):
    """K1 on the tensor-core body (`grouped_window_attention_relpos_v3_
    tc_torch`, the model with K1's packed table and the all-underflow
    rule) == the plain twin `grouped_window_attention_relpos_v3_torch` and
    the JAX `grouped_window_attention_relpos_v3` (Pallas, interpret mode,
    its EXP2_SHIFT softmax) on the same bf16 values, within FULL_TOL; the
    all-underflow row is exactly 0 in all three. 14 x 14 is SAM's window
    (4 key tiles, the last holding 4 keys), 5 x 5 one partial tile."""
    nw, heads, hw = 2, 2, (win, win)
    qkv, rel = _k1_inputs(np.random.default_rng(9), nw, win, heads, d)
    got = tsam.grouped_window_attention_relpos_v3_tc_torch(
        _t(qkv), _t(rel), hw, heads)
    plain = tsam.grouped_window_attention_relpos_v3_torch(_t(qkv), _t(rel),
                                                          hw, heads)
    want = np.asarray(jsam.grouped_window_attention_relpos_v3(
        jnp.asarray(qkv), jnp.asarray(rel), jnp.ones(1), hw, heads))
    _close(plain, want)
    for out in (got.numpy(), plain.numpy(), want):
        assert np.all(out[0, 0] == 0)
        assert np.all(np.abs(out[0, 1:]).max(-1) > 0)
    _within(got, plain, rows=False)
    _within(got, want, rows=False)


# K1q's int8 outputs, the model with the tensor-core body's rounding points
# against the fp32 twin and the TPU kernel (in interpret mode, on fp32
# values, so its P stays fp32): at most 1 LSB apart, on at most this share
# of the outputs. Measured on these inputs: 1.1-2.2% against either, the
# same outputs (the bf16 P moves an output by ~1e-2 LSB); the fp32 twin
# and the TPU kernel differ on at most 2e-5 of them.
K1Q_SHARE = 3e-2
# ... and against the TPU kernel on bf16 arrays of the same values, where
# it rounds q * scale * log2(e), the bias terms and P = exp2(s - EXP2_SHIFT)
# to bf16: measured 3.7-6.0% for the model and 3.4-5.7% for the fp32 twin.
# The body's bf16 P, rounded after the running max, is not the TPU
# kernel's rounding (P at a fixed offset, after a bf16 q): the model is no
# closer to that kernel than the fp32 twin is, and both stay within 1 LSB.
K1Q_BF16_SHARE = 8e-2


@pytest.mark.parametrize("win", [14, 5])
@pytest.mark.parametrize("d", [64, 80])
def test_tc_model_k1q_int8_within_lsb_of_twin_and_pallas(win, d):
    """K1q on the tensor-core body (the model with the int8 epilogue
    clip(rint(out * inv), -127, 127) after the all-underflow rule) against
    `grouped_window_attention_relpos_v3_q8_torch` (the fp32 twin) and the
    JAX kernel with quantize=True (Pallas, interpret mode) on fp32 arrays:
    the outputs span the int8 range, at most 1 LSB apart on at most
    K1Q_SHARE of them; against that kernel on bf16 arrays of the same
    values, the model and the twin at most 1 LSB apart on at most
    K1Q_BF16_SHARE; the all-underflow row is exactly 0 in all four."""
    nw, heads, hw = 2, 2, (win, win)
    qkv, rel = _k1_inputs(np.random.default_rng(11), nw, win, heads, d)
    inv = np.full((1,), 80.0, np.float32)
    got = tsam.grouped_window_attention_relpos_v3_tc_torch(
        _t(qkv), _t(rel), hw, heads, inv_scale=_t(inv))
    plain = tsam.grouped_window_attention_relpos_v3_q8_torch(
        _t(qkv), _t(rel), _t(inv), hw, heads)
    want, want_bf16 = (np.asarray(jsam.grouped_window_attention_relpos_v3(
        jnp.asarray(qkv, dt), jnp.asarray(rel, dt), jnp.asarray(inv), hw,
        heads, quantize=True)) for dt in (jnp.float32, jnp.bfloat16))
    assert got.dtype == torch.int8 and got.shape == plain.shape
    assert np.abs(want).max() == 127
    for out in (got.numpy(), plain.numpy(), want, want_bf16):
        assert np.all(out[0, 0] == 0)

    def lsb(a, b):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return diff.max(), (diff > 0).mean()

    for ref in (plain.numpy(), want):
        most, share = lsb(got.numpy(), ref)
        assert most <= 1 and share <= K1Q_SHARE, (most, share)
    for out in (got.numpy(), plain.numpy()):
        most, share = lsb(out, want_bf16)
        assert most <= 1 and share <= K1Q_BF16_SHARE, (most, share)


@pytest.mark.parametrize("grid", [14, 18])
@pytest.mark.parametrize("d", [64, 80])
def test_tc_model_k9_forward_matches_plain_and_pallas(grid, d):
    """K9's forward on the tensor-core body: the model with the bias and
    its LSE == `relpos_flash_fwd_lse_torch` and the JAX
    `relpos_flash_fwd_lse` (Pallas, interpret mode; its (B*H, n_blk,
    block) LSE reshaped to (B, H, S)) on bf16 values of `relpos_terms`'
    outputs: out within FULL_TOL, the LSE, which K9's dq and dkv read back
    as exp(s - lse), within 1e-4 of its max-abs. 14 x 14 (4 key tiles, a
    ragged last) and 18 x 18 (6, ragged)."""
    b, h = 1, 2
    s, hw = grid * grid, (grid, grid)
    rng = np.random.default_rng(10)
    q, k, v = (_bf16_values(rng, b, s, h, d) for _ in range(3))
    tables = [_t(_randn(rng, 2 * grid - 1, d) * 0.3) for _ in range(2)]
    rh, rw = (t.to(torch.bfloat16).float().numpy()
              for t in tsam.relpos_terms(_t(q), *tables, hw))
    scale = d ** -0.5
    got, got_lse = tattn.tc_attention_torch(
        _t(q), _t(k), _t(v), scale=scale, bias=(_t(rh), _t(rw), grid),
        lse=True)
    plain, plain_lse = trel.relpos_flash_fwd_lse_torch(
        _t(q), _t(k), _t(v), _t(rh), _t(rw), hw, scale)
    want, want_lse = jrel.relpos_flash_fwd_lse(
        *(jnp.asarray(x) for x in (q, k, v, rh, rw)), hw, scale)
    want_lse = np.asarray(want_lse).reshape(b, h, s)
    _close(plain, want)
    _close(plain_lse, want_lse)
    for ref, ref_lse in ((plain, plain_lse), (want, want_lse)):
        _within(got, ref, rows=False)
        _lse_within(got_lse, ref_lse)
