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
* `multi_head_attention`'s impl argument.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from grove_tpu.ops import attention as jattn  # noqa: E402
from grove_tpu_torch.config import LlamaConfig  # noqa: E402
from grove_tpu_torch.models import llama as tllama  # noqa: E402
from grove_tpu_torch.ops import attention as tattn  # noqa: E402
from grove_tpu_torch.ops import flash_backward as tflash  # noqa: E402

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
