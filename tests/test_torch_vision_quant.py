"""The W8A8-static vision towers of the port (grove_tpu_torch), against the
JAX package on the CPU: `quantize(vision=True)` + `calibrate`.

Kernels: the plain twins of K8a (`layernorm_quant_folded`), K8b
(`add_layernorm_quant_folded`) and K1q (the int8 epilogue of
`grouped_window_attention_relpos_v3`) against the JAX functions that reach
the Pallas kernels, run in interpret mode; numpy inputs from fixed seeds.
Two correct implementations of a rounding to int8 may differ by one LSB
where a value lies within float noise of a .5 boundary, so int8 outputs are
held to |diff| <= 1 on at most 0.1% of the elements (K1q: 0.5% of 1536),
and downstream floats relative to their max-abs. The quantizers and the
residual sums are byte-identical.

Towers: CLIP and SAM widened to C = 128, so that the JAX package takes its
K8b kernel route; static W8A8 outputs within 1e-2 of their max-abs. The
slice: `GroveConfig.tiny()` fp32, `quantize(bits=4, vision=True)` +
`calibrate` on both sides, identical greedy ids, boxes / objectness within
2e-3 (the tolerance of the JAX <-> reference parity tests).
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
from grove_tpu.models import layers as jlayers  # noqa: E402
from grove_tpu.models.clip import ClipVisionTower as JClip  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.models.sam_encoder import SamImageEncoder as JSam  # noqa
from grove_tpu.ops import fused_ln as jfln  # noqa: E402
from grove_tpu.ops import quant as jquant  # noqa: E402
from grove_tpu.ops import sam_attention as jsam  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_jax_quantized_llama, load_jax_quantized_towers,
    load_reference_state_dict)
from grove_tpu_torch.models import layers as tlayers  # noqa: E402
from grove_tpu_torch.models.clip import ClipVisionTransformer  # noqa: E402
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.models.sam_encoder import SamImageEncoder  # noqa: E402
from grove_tpu_torch.ops import fused_ln as tfln  # noqa: E402
from grove_tpu_torch.ops import quant as tquant  # noqa: E402
from grove_tpu_torch.ops import sam_attention as tsam  # noqa: E402
from test_torch_parity import (TOL, _frames, _perturb_zeros,  # noqa: E402
                               _prompt)

LSB_SHARE = 1e-3         # int8 outputs: share of elements allowed |diff| 1
TOWER_TOL = 1e-2         # static W8A8 tower outputs, of max-abs
SAM_PREFIX = "model.grounding_encoder.image_encoder."
CLIP_PREFIX = "model.vision_tower.vision_tower.vision_model."


def _t(x):
    return torch.from_numpy(np.array(x))          # a writable copy


def _int8_close(got, want, share=LSB_SHARE):
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert diff.astype(bool).mean() <= share, diff.astype(bool).mean()


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, np.asarray(v)


# ---------------------------------------------------------------------------
# activation quantizers, the linear and the conv
# ---------------------------------------------------------------------------

def test_quant_act_and_static_equal_jax():
    """Per-token and static quantizers give the JAX bytes and scales: a
    zero row takes the 1e-12 floor, values past the static range saturate
    at +-127, and .5 ties round to even."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 4).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 2, :4] = [2.5, -3.5, 0.5, 300.0]
    jq, js = jlayers.quant_act(jnp.asarray(x))
    tq, ts = tlayers.quant_act(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for scale in (1.0, 0.037):
        s = np.float32(scale)
        jq, _ = jlayers.quant_act_static(jnp.asarray(x), jnp.asarray(s))
        tq, _ = tlayers.quant_act_static(_t(x), torch.tensor(s))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.numpy().max() == 127 and tq.numpy().min() == -127
    got, _ = tlayers.quant_act_static(torch.tensor([[2.5, -3.5, 0.5, 300.]]),
                                      torch.tensor(1.0))
    assert got.tolist() == [[2, -4, 0, 127]]


@pytest.mark.parametrize("mode", ["dynamic", "static", "prequantized",
                                  "single_token"])
def test_int8_linear_w8a8_matches_int8_dense(mode):
    """`Int8Linear` in its W8A8 modes against `Int8Dense(act_quant=True)`,
    bias included, fp32; 1e-6 of the output's max-abs (the int8 products
    are exact on both sides)."""
    rng = np.random.default_rng(1)
    k, n = 64, 48
    x = rng.normal(size=(2, 7 if mode != "single_token" else 1,
                         k)).astype(np.float32)
    kq, scale = jquant.quantize_kernel(rng.normal(size=(k, n)))
    bias = rng.normal(size=n).astype(np.float32)
    params = {"kernel_q": jnp.asarray(kq), "scale": jnp.asarray(scale),
              "bias": jnp.asarray(bias)}
    static = mode == "static"
    if static:
        params["act_scale"] = jnp.asarray(np.float32(0.021))
    jmod = jlayers.Int8Dense(n, dtype=jnp.float32, use_bias=True,
                             act_quant=True, static_act=static)
    lin = tlayers.Int8Linear(k, n, bias=True, act_quant=True,
                             act_site=static, static_act=static,
                             dtype=torch.float32)
    lin.kernel_q.copy_(_t(kq))
    lin.scale.copy_(_t(scale))
    with torch.no_grad():
        lin.bias.copy_(_t(bias))
        if static:
            lin.act_scale.fill_(0.021)
        if mode == "prequantized":
            xq, sx = jlayers.quant_act(jnp.asarray(x))
            want = jmod.apply({"params": params}, xq, sx)
            got = lin(_t(xq), _t(sx))
        else:
            want = jmod.apply({"params": params}, jnp.asarray(x))
            got = lin(_t(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _rel_close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True])
def test_int8_conv3d_matches_conv3d_shifts(dtype, static):
    """The W8A8 adapter conv against `_Conv3dShifts(quant_w8a8=True)`: 27
    exact int8 taps, a bf16 running sum when x is bf16. fp32 within 1e-6 of
    max-abs; bf16 within 1e-2 (one bf16 ulp of the output)."""
    rng = np.random.default_rng(2)
    c = 16
    x = rng.normal(size=(2, 3, 4, 5, c)).astype(np.float32)
    kq, scale = jquant.quantize_kernel(rng.normal(size=(3, 3, 3, c, c)))
    bias = rng.normal(size=c).astype(np.float32) * 0.1
    params = {"kernel_q": jnp.asarray(kq), "scale": jnp.asarray(scale),
              "bias": jnp.asarray(bias)}
    if static:
        params["act_scale"] = jnp.asarray(np.float32(0.03))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = jlayers._Conv3dShifts(c, (3, 3, 3), dtype=jdt, quant_w8a8=True,
                                 static_act=static)
    want = jmod.apply({"params": params}, jnp.asarray(x, jdt))
    conv = tlayers.Int8Conv3d(c, (3, 3, 3), static_act=static, dtype=tdt)
    conv.kernel_q.copy_(_t(kq))
    conv.scale.copy_(_t(scale))
    with torch.no_grad():
        conv.bias.copy_(_t(bias))
        conv.act_scale.fill_(0.03)
        got = conv(_t(x).to(tdt))
    assert got.dtype == tdt
    _rel_close(got.float(), np.asarray(want, np.float32),
               1e-6 if dtype == "float32" else 1e-2)


# ---------------------------------------------------------------------------
# K8a / K8b: LayerNorm -> int8, plain twins vs the Pallas kernels
# ---------------------------------------------------------------------------

def _ln_inputs(seed, rows, c, dtype):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(rows, c)) * 2 + 0.3).astype(np.float32)
    b = rng.normal(size=(rows, c)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bt = (rng.normal(size=c) * 0.1).astype(np.float32)
    s = np.float32(0.031)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ((jnp.asarray(a, jd), jnp.asarray(b, jd), jnp.asarray(g),
             jnp.asarray(bt), jnp.asarray(s)),
            (_t(a).to(td), _t(b).to(td), _t(g), _t(bt), torch.tensor(s)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8a_layernorm_quant_matches_pallas(dtype):
    """C = 256 takes the JAX kernel route; 300 rows against 128-row blocks
    leave a ragged last block."""
    (ja, _, jg, jb, js), (ta, _, tg, tb, ts) = _ln_inputs(3, 300, 256, dtype)
    want = jfln.layernorm_quant(ja, jg, jb, js, eps=1e-5, block_rows=128,
                                use_kernel=True)
    gs, bs = tfln.fold_scales(tg, tb, ts)
    got = tfln.layernorm_quant_folded(ta, gs, bs, 1e-5)
    _int8_close(got, want)
    # the model-facing entry folds the same way on either route
    np.testing.assert_array_equal(
        tfln.layernorm_quant(ta, tg, tb, ts, eps=1e-5, use_kernel=True),
        tfln.layernorm_quant(ta, tg, tb, ts, eps=1e-5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8b_add_layernorm_quant_matches_pallas(dtype):
    """resid bit-equal to the kernel's. In bf16, XLA on the CPU runs the
    interpreted kernel with excess precision: its statistics come from the
    fp32 sum, not from resid rounded to bf16 (3.5% of its int8 outputs
    differ from the JAX package's own torch-free chain, which rounds). So
    the port, which rounds as the kernel's source does, is held to the JAX
    chain, and the interpreted kernel to the port's twin on the fp32 sum."""
    (ja, jb_, jg, jb, js), (ta, tb_, tg, tb, ts) = _ln_inputs(
        4, 300, 256, dtype)
    wr, wq = jfln.add_layernorm_quant(ja, jb_, jg, jb, js, eps=1e-6,
                                      block_rows=128)
    gs, bs = tfln.fold_scales(tg, tb, ts)
    gr, gq = tfln.add_layernorm_quant_folded(ta, tb_, gs, bs, 1e-6)
    assert gr.dtype == ta.dtype
    np.testing.assert_array_equal(gr.float().numpy(),
                                  np.asarray(wr, np.float32))
    if dtype == "float32":
        _int8_close(gq, wq)
        return
    _, chain = jfln.add_layernorm_quant(ja, jb_, jg, jb, js, eps=1e-6,
                                        use_kernel=False)
    _int8_close(gq, chain)
    _int8_close(tfln.layernorm_quant_folded_torch(
        ta.float() + tb_.float(), gs, bs, 1e-6), wq)


# ---------------------------------------------------------------------------
# K1q: windowed attention with the int8 epilogue
# ---------------------------------------------------------------------------

def test_k1q_window_attention_q8_matches_pallas():
    """`sam_window_attention_fused_q8`: 2 windows of 4 x 4, 3 heads of 16,
    the proj scale set so the outputs span the int8 range. Row 0 of window
    0 has every logit near -800 (log2 units), far below EXP2_SHIFT - 126:
    the TPU kernel underflows it to 0, and so does the port."""
    rng = np.random.default_rng(5)
    nw, win, heads, d = 2, 4, 3, 16
    s, c = win * win, heads * d
    qkv = rng.normal(size=(nw, s, 3 * c)).astype(np.float32)
    kq = qkv[0].reshape(s, 3, heads, d)
    kq[:, 1] = 1.0 + 0.3 * rng.normal(size=(s, heads, d))
    kq[0, 0] = -73.0
    # small tables: on the -73 row a rel term is 73 * sum(rel), which must
    # not lift its logits back above the underflow line
    rel_h = (rng.normal(size=(2 * win - 1, d)) * 0.02).astype(np.float32)
    rel_w = (rng.normal(size=(2 * win - 1, d)) * 0.02).astype(np.float32)
    act = np.float32(0.01)
    want = jsam.sam_window_attention_fused_q8(
        jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w),
        (win, win), heads, jnp.asarray(act))
    got = tsam.sam_window_attention_fused_q8(
        _t(qkv), _t(rel_h), _t(rel_w), (win, win), heads, torch.tensor(act))
    assert got.dtype == torch.int8 and got.shape == (nw, s, c)
    w = np.asarray(want)
    assert np.abs(w).max() == 127 and np.all(w[0, 0] == 0)
    assert torch.all(got[0, 0] == 0)
    _int8_close(got, want, share=5e-3)


# ---------------------------------------------------------------------------
# the towers at C = 128
# ---------------------------------------------------------------------------

def _wide_cfgs():
    cfg = GroveConfig.tiny()
    clip = dataclasses.replace(cfg.clip, hidden_size=128,
                               intermediate_size=256)
    sam = dataclasses.replace(cfg.sam_enc, img_size=48, embed_dim=128)
    return clip, sam


def _with(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(scope="module")
def sam_tower():
    """(cfg, JAX float params, port float encoder, frames): grid 3 x 3 in
    windows of 2 (padded to 4 x 4), one global block, C = 128."""
    _, cfg = _wide_cfgs()
    rng = np.random.default_rng(6)
    frames = rng.normal(size=(1, 2, 48, 48, 3)).astype(np.float32)
    params = JSam(cfg=cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.asarray(frames))["params"]
    params = _perturb_zeros(params, rng)
    sd = to_torch_state_dict({"grounding_encoder": params}, None)
    enc = SamImageEncoder(cfg, dtype=torch.float32)
    enc.load_state_dict({k[len(SAM_PREFIX):]: _t(v) for k, v in sd.items()})
    return cfg, params, enc.eval(), frames


@pytest.fixture(scope="module")
def clip_tower():
    cfg, _ = _wide_cfgs()
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(1, 2, 28, 28, 3)).astype(np.float32)
    kw = dict(pool_thw=(2, 1, 2), num_region_levels=1)
    params = JClip(cfg=cfg, dtype=jnp.float32, **kw).init(
        jax.random.PRNGKey(1), jnp.asarray(frames))["params"]
    params = _perturb_zeros(params, rng)
    sd = to_torch_state_dict({"vision_tower": params}, None)
    tower = ClipVisionTransformer(cfg, kw["pool_thw"], 1,
                                  dtype=torch.float32)
    tower.load_state_dict({k[len(CLIP_PREFIX):]: _t(v)
                           for k, v in sd.items()})
    return cfg, params, tower.eval(), frames, kw


def _port_leaves(tower, clip):
    """The quantized leaves of a port tower under their JAX paths."""
    out = {}
    for name, buf in tower.named_buffers():
        mod, leaf = name.rsplit(".", 1)
        out[f"{tquant.jax_site_path(mod, clip)}/{leaf}"] = buf.numpy()
    return out


@pytest.mark.parametrize("which", ["sam", "clip"])
def test_quantize_towers_byte_identical_to_trees(which, sam_tower,
                                                 clip_tower):
    """`quantize_sam_` / `quantize_clip_` give every kernel_q (the 5-D
    adapter kernels included) and scale of `quantize_sam_tree` /
    `quantize_clip_tree`, and a quantized config builds the same module
    tree directly."""
    if which == "sam":
        cfg, params, tower = sam_tower[:3]
        tq = tquant.quantize_sam_(copy.deepcopy(tower))
        jq = jquant.quantize_sam_tree(params)
        fresh = SamImageEncoder(tq.cfg, dtype=torch.float32)
    else:
        cfg, params, tower = clip_tower[:3]
        tq = tquant.quantize_clip_(copy.deepcopy(tower))
        jq = jquant.quantize_clip_tree(params)
        fresh = ClipVisionTransformer(tq.cfg, (2, 1, 2), 1,
                                      dtype=torch.float32)
    assert tq.cfg.quant_w8a8 and not tq.cfg.quant_static_act
    got = _port_leaves(tq, which == "clip")
    flat = dict(_flat(jq))
    sites = {p.rsplit("/", 1)[0] for p in flat if p.endswith("/kernel_q")}
    want = {p: v for p, v in flat.items()
            if p.rsplit("/", 1)[0] in sites
            and p.rsplit("/", 1)[1] in ("kernel_q", "scale")}
    assert any(v.ndim == 5 for v in want.values())
    for path, v in want.items():
        assert got[path].dtype == v.dtype, path
        np.testing.assert_array_equal(got[path], v, err_msg=path)
    n_quant = sum(p.endswith("kernel_q") for p in got)
    assert n_quant == sum(p.endswith("kernel_q") for p in want)
    fresh.load_state_dict(tq.state_dict(), strict=True)
    with pytest.raises(TypeError, match="already quantized"):
        (tquant.quantize_sam_ if which == "sam" else tquant.quantize_clip_)(tq)


def _calibrated(which, sam_tower, clip_tower):
    """Both sides quantized, calibrated on the same frames and run static:
    (JAX stats, port stats, JAX static params, JAX out, port out)."""
    if which == "sam":
        cfg, params, tower, frames = sam_tower
        jq = jquant.quantize_sam_tree(params)
        mk = lambda c: JSam(cfg=c, dtype=jnp.float32)  # noqa: E731
        tq = tquant.quantize_sam_(copy.deepcopy(tower))
    else:
        cfg, params, tower, frames, kw = clip_tower
        jq = jquant.quantize_clip_tree(params)
        mk = lambda c: JClip(cfg=c, dtype=jnp.float32, **kw)  # noqa: E731
        tq = tquant.quantize_clip_(copy.deepcopy(tower))
    clip = which == "clip"
    jdyn = mk(_with(cfg, quant_w8a8=True))
    jstats = jquant.collect_act_stats(jdyn, jq, jnp.asarray(frames))
    jps = jquant.install_act_scales(jq, jstats)
    jout = mk(_with(cfg, quant_w8a8=True, quant_static_act=True)).apply(
        {"params": jps}, jnp.asarray(frames))
    with torch.no_grad():
        tstats = tquant.collect_act_stats(tq, lambda: tq(_t(frames)), clip)
    tquant.install_act_scales(tq, tstats, clip)
    tquant.set_static_act_(tq, True)
    with torch.no_grad():
        tout = tq(_t(frames))
    if clip:
        jout, tout = jout[0], tout[0]
    return jstats, tstats, jps, jout, tout, tq


@pytest.mark.parametrize("which", ["sam", "clip"])
def test_calibration_and_static_towers_match_jax(which, sam_tower,
                                                 clip_tower):
    """One dynamic calibration pass records the same sites with the same
    absmax (1e-4 relative: the first site is exact, later ones carry the
    LSB flips of the sites before); the installed scales follow; the
    static tower's output is within 1e-2 of the JAX one's max-abs."""
    jstats, tstats, jps, jout, tout, tq = _calibrated(which, sam_tower,
                                                      clip_tower)
    jflat = dict(_flat(jstats))
    assert set(tstats) == set(jflat)
    assert len(tstats) >= 9
    for key, v in jflat.items():
        np.testing.assert_allclose(tstats[key], float(v), rtol=1e-4,
                                   err_msg=key)
    got = _port_leaves(tq, which == "clip")
    for path, v in _flat(jps):
        if path.endswith("act_scale"):
            np.testing.assert_allclose(got[path], v, rtol=1e-4,
                                       err_msg=path)
    _rel_close(tout, jout, TOWER_TOL)


def test_merge_and_install_are_strict(sam_tower):
    tq = tquant.quantize_sam_(copy.deepcopy(sam_tower[2]))
    stats = {f"{p}/{s}": 1.0 for p, _, s in tquant.act_sites(tq, False)}
    merged = tquant.merge_act_stats(stats, {k: 2.0 for k in stats})
    assert set(merged.values()) == {2.0}
    tquant.install_act_scales(tq, merged, False, margin=1.27)
    assert float(tq.blocks[0].norm1.act_scale) == pytest.approx(0.02)
    assert float(tq.blocks[1].attn.proj_act_scale) == pytest.approx(0.02)
    with pytest.raises(KeyError, match="no stat"):
        tquant.install_act_scales(tq, dict(list(stats.items())[1:]), False)
    with pytest.raises(KeyError, match="no site"):
        tquant.install_act_scales(tq, {**stats, "blocks_9/x/absmax": 1.0},
                                  False)
    with pytest.raises(KeyError, match="differ"):
        tquant.merge_act_stats(stats, {})


# ---------------------------------------------------------------------------
# the slice at GroveConfig.tiny(): int4 LLM, int8 KV, W8A8-static towers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_lm():
    """(cfg, calibrated JAX LM, calibrated port model, float JAX params):
    both sides quantize the same weights and calibrate on the same clip."""
    cfg = GroveConfig.tiny()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    fc, fs = _frames(cfg, np.random.default_rng(11), 1)
    jlm = JaxLM(cfg, jmodel, {"params": params}).quantize(
        vision=True, bits=4).calibrate(jnp.asarray(fc), jnp.asarray(fs))
    from grove_tpu_torch.api import GroveForCausalLM
    tm = GroveModel(cfg, device="cpu", dtype=torch.float32).eval()
    load_reference_state_dict(tm, to_torch_state_dict(params, cfg))
    lm = GroveForCausalLM(cfg, tm).quantize(bits=4, vision=True)
    lm.calibrate(_t(fc), _t(fs))
    return jlm.cfg, jlm, lm, params


def test_slice_config_and_scales_match(slice_lm):
    cfg, jlm, lm, _ = slice_lm
    assert lm.cfg == cfg
    assert lm.model.cfg is lm.cfg
    got = {}
    for key, tower in tquant.vision_towers(lm.model).items():
        for path, v in _port_leaves(tower, key == "vision_tower").items():
            got[f"{key}/{path}"] = v
    n = 0
    for path, v in _flat(jlm.variables["params"]):
        if path.endswith("act_scale"):
            np.testing.assert_allclose(got[path], v, rtol=1e-4,
                                       err_msg=path)
            n += 1
    assert n == sum(p.endswith("act_scale") for p in got) == 22


def test_w8a8_static_infer_clips_batched_matches(slice_lm):
    """Two clips (one with the default instruction, one with another), the
    int8 KV cache as `_decode_kwargs("int8", ...)` builds it."""
    from grove_tpu.infer import sliding as jsl
    from grove_tpu_torch.api.processor import _decode_kwargs
    from grove_tpu_torch.infer import sliding as tsl
    cfg, jlm, lm, _ = slice_lm
    tok = MockTokenizer()
    rng = np.random.default_rng(9)
    fc, fs = _frames(cfg, rng, 2, 6)
    clips = [{"frames_clip": fc[i], "frames_sam": fs[i],
              "original_size": (64, 48)} for i in range(2)]
    ins = [None, "What is happening in this video clip? Describe it."]
    want = jsl.infer_clips_batched(
        jlm.model, jlm.variables, cfg, tok, clips, instruction=ins,
        max_new_tokens=10, decode_kwargs={"cache_dtype": jnp.int8})
    got = tsl.infer_clips_batched(lm.model, lm.cfg, tok, clips,
                                  instruction=ins, max_new_tokens=10,
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


def test_w8a8_static_generate_grounded_matches(slice_lm):
    from grove_tpu.infer.generate import generate_grounded as jgen
    from grove_tpu_torch.infer.generate import generate_grounded as tgen
    cfg, jlm, lm, _ = slice_lm
    tok = MockTokenizer()
    rng = np.random.default_rng(8)
    fc, fs = _frames(cfg, rng, 2)
    ids, vs, _ = _prompt(cfg, rng, 2)
    want = jgen(jlm.model, jlm.variables, cfg, tok, ids.astype(np.int32),
                vs.astype(np.int32), jnp.asarray(fc), jnp.asarray(fs),
                max_new_tokens=12, cache_dtype=jnp.int8)
    got = tgen(lm.model, lm.cfg, tok, ids, vs, _t(fc), _t(fs),
               max_new_tokens=12, cache_dtype=torch.int8)
    np.testing.assert_array_equal(got["generated_ids"],
                                  want["generated_ids"])
    np.testing.assert_allclose(got["pred_boxes"], want["pred_boxes"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["objectness_logits"],
                               want["objectness_logits"], rtol=TOL,
                               atol=TOL)


def test_load_jax_quantized_towers_is_strict(slice_lm):
    """The calibrated JAX tree's tower leaves land leaf for leaf (the
    port's own bytes and scales come back unchanged but for the scales'
    float noise); an unknown quantized leaf and a missing one raise; the
    LLM loader ignores the towers' buffers."""
    cfg, jlm, lm, _ = slice_lm
    tm = copy.deepcopy(lm.model)
    jp = jlm.variables["params"]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    load_jax_quantized_towers(tm, jp)
    load_jax_quantized_llama(tm, jp)
    for k, v in tm.state_dict().items():
        if k.endswith("act_scale"):
            torch.testing.assert_close(v, before[k], rtol=1e-4, atol=0)
        else:
            assert torch.equal(v, before[k]), k
    extra = copy.deepcopy(jp)
    extra["grounding_encoder"]["blocks_0"]["attn"]["qkv"]["act_scale"] = \
        np.float32(1.0)
    with pytest.raises(KeyError, match="has no buffer"):
        load_jax_quantized_towers(tm, extra)
    short = copy.deepcopy(jp)
    del short["vision_tower"]["adapters_0"]["adapter"]["conv3d"]["act_scale"]
    with pytest.raises(KeyError, match="no leaf"):
        load_jax_quantized_towers(tm, short)
    fresh = GroveModel(lm.cfg, device="cpu", dtype=torch.float32)
    fresh.load_state_dict(tm.state_dict(), strict=True)
