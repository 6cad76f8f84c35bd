"""The quantized serving slice of the port (grove_tpu_torch): int4 / int8
LLM weights and the int8 KV cache, against the JAX package on the CPU.

Kernels: the plain twins of K5 (`prefill_attention_raw`), K6
(`int8_cache_decode_attention`) and K7a (`int4_matmul`) against the JAX
functions that reach the Pallas kernels, run in interpret mode; numpy
inputs from fixed seeds, fp32. Tolerances: K7a and K6 1e-4 of the output's
max-abs, K5 2e-5 (rtol = atol). The quantizers are byte-identical.

Slice: `GroveConfig.tiny()` fp32 with `weight_quant=True,
weight_quant_bits=4`, the JAX tree quantized by `quantize_llama_tree_int4`
and the same bytes carried into the port; with an int8 cache the greedy
ids are identical and boxes / objectness agree within 2e-3, the tolerance
of the JAX <-> reference parity tests.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.api.model import GroveForCausalLM as JaxLM  # noqa: E402
from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.models.grove import GroveModel as JaxGrove  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.ops import attention as jattn  # noqa: E402
from grove_tpu.ops import decode_attention as jdec  # noqa: E402
from grove_tpu.ops import int4_matmul as jint4  # noqa: E402
from grove_tpu.ops import quant as jquant  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_jax_quantized_llama, load_reference_state_dict)
from grove_tpu_torch.models import llama as tllama  # noqa: E402
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.models.layers import Int4Linear  # noqa: E402
from grove_tpu_torch.ops import attention as tattn  # noqa: E402
from grove_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from grove_tpu_torch.ops import int4_matmul as tint4  # noqa: E402
from grove_tpu_torch.ops import quant as tquant  # noqa: E402
from test_torch_parity import (TOL, _close, _frames,  # noqa: E402
                               _perturb_zeros, _prompt, port_config)

KERNEL_TOL = 1e-4        # K6, K7a: of the output's max-abs
PREFILL_TOL = 2e-5       # K5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(512, 384), (32, 32)])
def test_quantizers_are_byte_identical(shape):
    """int4 (group 128, halved to 16 at K = 32) and per-channel int8 give
    the JAX package's bytes and scales; unpack inverts pack."""
    k = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jp, js = jquant.quantize_kernel_int4(k, 128)
    tp, ts = tquant.quantize_kernel_int4(_t(k), 128)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(ts.numpy(), js)
    group = shape[0] // js.shape[0]
    assert group == (128 if shape[0] == 512 else 16)
    np.testing.assert_array_equal(
        tquant.unpack_int4(tp, group).numpy(),
        np.asarray(jquant.unpack_int4(jnp.asarray(jp), group)))
    q = np.random.default_rng(1).integers(-8, 8, size=shape).astype(np.int8)
    packed = tquant.pack_int4(_t(q), group)
    np.testing.assert_array_equal(packed.numpy(), jquant.pack_int4(q, group))
    np.testing.assert_array_equal(
        tquant.unpack_int4(packed, group).numpy().reshape(shape), q)
    jq, jsc = jquant.quantize_kernel(k)
    tq, tsc = tquant.quantize_kernel(_t(k))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(tsc.numpy(), jsc)
    # a transposed nn.Linear weight, as quantize_llama_ passes it: the
    # buffers come out contiguous, as the CUDA kernels require
    kt = _t(k.T.copy()).t()
    for out in (*tquant.quantize_kernel_int4(kt, 128),
                *tquant.quantize_kernel(kt)):
        assert out.is_contiguous()


def test_quantize_kv_is_identical():
    from grove_tpu.models.llama import _quantize_kv
    x = np.random.default_rng(2).normal(size=(2, 9, 3, 16)).astype(
        np.float32) * 3
    x[0, 0, 0] = 0.0                              # the 1e-8 floor
    jq, js = _quantize_kv(jnp.asarray(x))
    tq, ts = tllama.quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js, np.float32))


# ---------------------------------------------------------------------------
# K7a: W4A16 matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 5])
def test_k7a_int4_matmul_matches_pallas(m):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(m, 512)).astype(np.float32)
    wp, scale = jquant.quantize_kernel_int4(
        rng.normal(size=(512, 384)).astype(np.float32), 128)
    want = jint4.int4_matmul(jnp.asarray(x), jnp.asarray(wp),
                             jnp.asarray(scale))
    got = tint4.int4_matmul(_t(x), _t(wp), _t(scale))
    assert got.shape == (m, 384) and got.dtype == torch.float32
    _rel_close(got, want, KERNEL_TOL)


def test_k7a_plain_matches_int4_dense_einsum():
    """At a tiny group (16) the plain twin, and `Int4Linear` on the CPU,
    equal the CPU branch of the JAX `Int4Dense` (grouped einsum)."""
    from grove_tpu.models.layers import Int4Dense
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    wp, scale = jquant.quantize_kernel_int4(
        rng.normal(size=(64, 24)).astype(np.float32), 16)
    want = Int4Dense(24, group=16, dtype=jnp.float32).apply(
        {"params": {"kernel_q4p": jnp.asarray(wp),
                    "scale": jnp.asarray(scale)}}, jnp.asarray(x))
    got = tint4.int4_matmul_torch(_t(x).reshape(6, 64), _t(wp), _t(scale))
    _rel_close(got.reshape(2, 3, 24), want, KERNEL_TOL)
    lin = Int4Linear(64, 24, 16, dtype=torch.float32)
    lin.kernel_q4p.copy_(_t(wp))
    lin.scale.copy_(_t(scale))
    with torch.no_grad():
        _rel_close(lin(_t(x)), want, KERNEL_TOL)


# ---------------------------------------------------------------------------
# K6: decode attention over the int8 cache
# ---------------------------------------------------------------------------

def _int8_cache(rng, b, hkv, c, d):
    kt, vt = (rng.integers(-127, 128, size=(b, hkv, c, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, size=(b, hkv, c)).astype(np.float32)
              for _ in range(2))
    bias = np.zeros((b, c), np.float32)
    bias[0, 180:] = tdec.NEG_INF                  # unwritten tail
    bias[1, :7] = tdec.NEG_INF                    # a left pad
    bias[1, 100:] = tdec.NEG_INF
    return kt, vt, ks, vs, bias


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2)])
def test_k6_decode_attention_matches_pallas(h, hkv, d):
    """The plain twin follows the TPU kernel's numerics (in-kernel q
    quantization, bf16 v-scaled weights) to 1e-4 of the output's max-abs,
    GQA and masked slots included; and it stays within the JAX package's
    own 5e-3 / 5e-2 of the dequantize-then-attend oracle."""
    rng = np.random.default_rng(5)
    b, c = 2, 256
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kt, vt, ks, vs, bias = _int8_cache(rng, b, hkv, c, d)
    jargs = (jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt),
             jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16),
             jnp.asarray(bias))
    targs = (_t(q), _t(kt), _t(vt), _t(ks).to(torch.bfloat16),
             _t(vs).to(torch.bfloat16), _t(bias))
    got = tdec.int8_cache_decode_attention(*targs)
    _rel_close(got, jdec.int8_cache_decode_attention(*jargs), KERNEL_TOL)
    ref = tdec.decode_attention_reference(*targs)
    _close(ref, jdec.decode_attention_reference(*jargs), 1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-3,
                               rtol=5e-2)


# ---------------------------------------------------------------------------
# K5: raw-layout causal prefill with left pads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,d", [(2, 24, 4, 16), (2, 136, 2, 128)])
def test_k5_prefill_attention_matches_pallas(b, s, h, d):
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(b, s, h * d)).astype(np.float32)
               for _ in range(3))
    pads = np.array([0, 5], np.int32)
    scale = 1.0 / d ** 0.5
    want = jattn.prefill_attention_raw(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(pads), h,
                                       scale)
    got = tattn.prefill_attention_raw(_t(q), _t(k), _t(v), _t(pads), h,
                                      scale)
    _close(got, want, PREFILL_TOL)
    # pure causal: the cache-free forward at a ragged S
    want = jattn.prefill_attention_trainable(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, scale)
    _close(tattn.prefill_attention_trainable(_t(q), _t(k), _t(v), h, scale),
           want, PREFILL_TOL)


# ---------------------------------------------------------------------------
# the slice at GroveConfig.tiny(), int4 weights, int8 KV cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_models():
    """(cfg_q, JAX int4 LM, port float model, port int4 model, float JAX
    params): the port's int4 model holds the JAX tree's quantized bytes."""
    cfg = GroveConfig.tiny()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    jlm = JaxLM(cfg, jmodel, {"params": params}).quantize(bits=4)
    sd = to_torch_state_dict(params, cfg)
    tfloat = GroveModel(port_config(cfg), device="cpu",
                        dtype=torch.float32).eval()
    load_reference_state_dict(tfloat, sd)
    tq = tquant.quantize_llama_(copy.deepcopy(tfloat), 4)
    load_jax_quantized_llama(tq, jlm.variables["params"])
    return jlm.cfg, jlm, tfloat, tq, params


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_llama_matches_jax_tree_and_loads(slice_models, bits):
    """`quantize_llama_` on the port's float weights gives the buffers of
    the JAX tree transform; the JAX bytes then load strictly, and a
    quantized config builds the same module tree directly."""
    _, _, tfloat, _, params = slice_models
    jq = (jquant.quantize_llama_tree_int4(params) if bits == 4
          else jquant.quantize_llama_tree(params))
    tm = tquant.quantize_llama_(copy.deepcopy(tfloat), bits)
    assert tm.cfg.llama.weight_quant
    assert tm.cfg.llama.weight_quant_bits == bits
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    load_jax_quantized_llama(tm, jq)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    fresh = GroveModel(tm.cfg, device="cpu", dtype=torch.float32)
    assert type(fresh.lm_head) is type(tm.lm_head)
    assert torch.all(fresh.lm_head.scale == 1)
    fresh.load_state_dict(tm.state_dict(), strict=True)
    short = {k: v for k, v in jq.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="no leaf"):
        load_jax_quantized_llama(tm, short)


def _jax(jlm, method, *args):
    return jax.jit(lambda v, *a: jlm.model.apply(v, *a, method=method))(
        jlm.variables, *args)


def test_int8_cache_prefill_decode_with_left_pad_matches(slice_models):
    """Prefill (K5's plain twin) and three decode steps (K6's) over the
    int8 cache with a left-padded row. Prefill hidden states and logits
    within 2e-3. The int8 slabs agree but for rare one-LSB flips (an fp32
    value within rounding noise of a .5 boundary: here one v entry of
    layer 0), and such a flip moves a decode step of this 8-wide model by
    up to ~5e-3, so decode steps are held to 1e-2 of their max-abs."""
    from grove_tpu.models.llama import init_kv_caches as jinit
    cfg, jlm, _, tq, _ = slice_models
    ids, vs, feats = _prompt(cfg, np.random.default_rng(7), 2)
    pad = np.array([0, 3], np.int64)
    ids[1, :3] = cfg.tokens.pad
    vs[1] += 3
    ids[1, 3] = cfg.tokens.bos
    ls = ids.shape[1]
    jc = jinit(cfg.llama, 2, ls + 3, dtype=jnp.int8)
    tc = tllama.init_kv_caches(tq.cfg.llama, 2, ls + 3, dtype=torch.int8,
                               device="cpu")
    assert tc[0]["k"].shape == jc[0]["k"].shape == (2, 4, 128, 8)
    pad_t = _t(pad)
    wh, wl, jc = _jax(jlm, JaxGrove.prefill, jnp.asarray(ids, jnp.int32),
                      jnp.asarray(feats), jnp.asarray(vs, jnp.int32), jc,
                      jnp.asarray(pad, jnp.int32))
    with torch.inference_mode():
        gh, gl, tc = tq.prefill(_t(ids), _t(feats), vs, tc, pad_t)
    _close(gh, wh)
    _close(gl, wl)
    tok = np.argmax(np.asarray(wl)[:, -1], -1)[:, None]
    for i in range(3):
        wh, wl, jc = _jax(
            jlm, lambda m, t, c, p: m.decode_step(t, ls + i, c, p),
            jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pad, jnp.int32))
        with torch.inference_mode():
            gh, gl, tc = tq.decode_step(_t(tok), ls + i, tc, pad_t)
        _rel_close(gh, wh, 1e-2)
        _rel_close(gl, wl, 1e-2)
        tok = np.argmax(np.asarray(wl)[:, -1], -1)[:, None]
    for layer in range(cfg.llama.num_layers):
        for name in ("k", "v"):
            agree = np.mean(tc[layer][name].numpy()
                            == np.asarray(jc[layer][name]))
            assert agree > 0.999, (layer, name, agree)
            _rel_close(tc[layer][name + "_s"].float(),
                       np.asarray(jc[layer][name + "_s"], np.float32), 1e-2)


def test_int4_int8kv_generate_grounded_matches(slice_models):
    from grove_tpu.infer.generate import generate_grounded as jgen
    from grove_tpu_torch.infer.generate import generate_grounded as tgen
    cfg, jlm, _, tq, _ = slice_models
    tok = MockTokenizer()
    rng = np.random.default_rng(8)
    fc, fs = _frames(cfg, rng, 2)
    ids, vs, _ = _prompt(cfg, rng, 2)
    want = jgen(jlm.model, jlm.variables, cfg, tok, ids.astype(np.int32),
                vs.astype(np.int32), jnp.asarray(fc), jnp.asarray(fs),
                max_new_tokens=12, cache_dtype=jnp.int8)
    got = tgen(tq, tq.cfg, tok, ids, vs, _t(fc), _t(fs), max_new_tokens=12,
               cache_dtype=torch.int8)
    np.testing.assert_array_equal(got["generated_ids"],
                                  want["generated_ids"])
    _close(got["pred_boxes"], want["pred_boxes"])
    _close(got["objectness_logits"], want["objectness_logits"])
    assert got["parsed"] == want["parsed"]


def test_int4_int8kv_infer_clips_batched_matches(slice_models):
    """Two clips with prompts of unequal length (one left-padded pair),
    decode options as `_decode_kwargs("int8", ...)` builds them."""
    from grove_tpu.infer import sliding as jsl
    from grove_tpu_torch.api.processor import _decode_kwargs
    from grove_tpu_torch.infer import sliding as tsl
    cfg, jlm, _, tq, _ = slice_models
    tok = MockTokenizer()
    rng = np.random.default_rng(9)
    fc, fs = _frames(cfg, rng, 2, 6)
    clips = [{"frames_clip": fc[i], "frames_sam": fs[i],
              "original_size": (64, 48)} for i in range(2)]
    ins = [None, "What is happening in this video clip? Describe it."]
    want = jsl.infer_clips_batched(
        jlm.model, jlm.variables, cfg, tok, clips, instruction=ins,
        max_new_tokens=10, decode_kwargs={"cache_dtype": jnp.int8})
    got = tsl.infer_clips_batched(tq, tq.cfg, tok, clips, instruction=ins,
                                  max_new_tokens=10,
                                  decode_kwargs=_decode_kwargs("int8", True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key in ("bboxes", "probs_temp_objectness"):
                for a, b in zip(g[key], w[key]):
                    tol = TOL * (64 if key == "bboxes" else 1)
                    np.testing.assert_allclose(a, b, rtol=TOL, atol=tol)
            else:
                assert g[key] == w[key], key


def test_int4_forward_boxes_matches(slice_models):
    cfg, jlm, _, tq, _ = slice_models
    rng = np.random.default_rng(10)
    fc, fs = _frames(cfg, rng, 2)
    ids, vs, _ = _prompt(cfg, rng, 2)
    ids = np.pad(ids, ((0, 0), (0, 64 - ids.shape[1] % 64)))
    det = np.tile(np.array([[ids.shape[1] - 60, 20, 0, 0]]), (2, 1))
    batch = {"frames_clip": fc, "frames_sam": fs, "input_ids": ids,
             "video_start": vs, "det_positions": det}
    want = _jax(jlm, JaxGrove.forward_boxes,
                {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got = tq.forward_boxes({k: (_t(v) if k != "video_start" else v)
                                for k, v in batch.items()})
    _close(got["pred_boxes"], want["pred_boxes"])
    _close(got["objectness_logits"], want["objectness_logits"])


def test_grove_for_causal_lm_quantize_in_place(tmp_path):
    from grove_tpu_torch.api import GroveForCausalLM
    lm = GroveForCausalLM.from_pretrained(None, "tiny", dtype=torch.float32,
                                          seed=3, device="cpu")
    model = lm.model
    assert lm.quantize(bits=4) is lm and lm.model is model
    assert lm.cfg.llama.weight_quant_bits == 4 and model.cfg is lm.cfg
    assert isinstance(model.model.layers[0].mlp.down_proj, Int4Linear)
    # the quantized instance round-trips through its model directory
    lm.save_pretrained(str(tmp_path))
    back = GroveForCausalLM.from_pretrained(str(tmp_path),
                                            dtype=torch.float32,
                                            device="cpu")
    assert back.cfg.to_dict() == lm.cfg.to_dict()
    assert isinstance(back.model.model.layers[0].mlp.down_proj, Int4Linear)
    for name, t in model.state_dict().items():
        assert torch.equal(back.model.state_dict()[name], t), name
    cfg = dataclasses.replace(port_config(GroveConfig.tiny()).llama,
                              weight_quant=True, weight_quant_bits=3)
    with pytest.raises(ValueError, match="4 or 8"):
        tllama.LlamaModel(cfg, device="meta")
