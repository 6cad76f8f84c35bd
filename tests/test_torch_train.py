"""The port's training slice (grove_tpu_torch) against the JAX package on
the CPU, fp32, small sizes.

* K4b and K9: the plain twins == `flash_backward` and `relpos_flash_fwd_lse`
  / `relpos_flash_bwd` with their Pallas kernels in interpret mode
  (tolerance 1e-4, as `test_torch_kernels.py`);
* `torch.autograd.gradcheck` in float64 on every autograd Function the
  slice adds (the twins keep float64);
* boxes and losses, the hand-written AdamW against optax, and the trainable
  set against the JAX `trainable_mask` read through `to_torch_state_dict`;
* the tiny slice: the JAX `make_train_step` and the port's over 2 steps on
  one `build_batch` batch (loss terms within 1e-4 relative, gradients
  within rtol = atol = 2e-3, the parity suite's tolerance, trainable
  parameters within 1e-4 after step 2), at a tiny config whose SAM has a
  windowed and a global block after its first adapter and whose LLaMA runs
  at S = 128, so K1, K2, K4 and their backwards (K4b, K9) are all on the
  path;
* the grad guard, and the zero-padding logic of the card's int8 GEMM.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.data.collate import build_batch  # noqa: E402
from grove_tpu.models.grove import GroveModel as JaxGrove  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.ops import boxes as jboxes  # noqa: E402
from grove_tpu.ops import flash_backward as jflash  # noqa: E402
from grove_tpu.ops import losses as jlosses  # noqa: E402
from grove_tpu.ops import sam_attention_bwd as jrel  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch import _kernels  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_reference_state_dict)
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.ops import attention as tattn  # noqa: E402
from grove_tpu_torch.ops import boxes as tboxes  # noqa: E402
from grove_tpu_torch.ops import flash_backward as tflash  # noqa: E402
from grove_tpu_torch.ops import int8_matmul as tint8  # noqa: E402
from grove_tpu_torch.ops import losses as tlosses  # noqa: E402
from grove_tpu_torch.ops import sam_attention as tsam  # noqa: E402
from grove_tpu_torch.ops import sam_attention_bwd as trel  # noqa: E402
from grove_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_parity import _perturb_zeros, port_config  # noqa: E402

TOL = 1e-4              # twins vs the Pallas kernels, fp32
SLICE_TOL = 2e-3        # gradients of the tiny slice (the parity suite's)
LOSS_REL = 1e-4         # loss terms of the tiny slice, relative
PARAM_TOL = 1e-4        # trainable parameters after step 2, absolute
CAPTION = "a man slices bread on a wooden board"
SPANS = [(0, 5), (13, 18), (22, 36)]


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# K4b and K9 twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_k4b_flash_backward_matches_pallas(causal):
    """The twins of K4 and K4b (dq; dk, dv) == `flash_forward_lse` /
    `flash_backward` at (1, 128, 2, 64), block 64, the LSE reshaped from
    the JAX (B*H, n_blk, block) layout."""
    rng = np.random.default_rng(0)
    b, s, h, d, block = 1, 128, 2, 64, 64
    q, k, v, g = (_randn(rng, b, s, h, d) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jout, jlse = jflash.flash_forward_lse(jq, jk, jv, causal=causal,
                                          scale=scale, block=block)
    want = jflash.flash_backward(jq, jk, jv, jout, jlse, jg, causal=causal,
                                 scale=scale, block=block)
    out, lse = tflash.flash_forward_lse(_t(q), _t(k), _t(v), causal=causal,
                                        scale=scale)
    _close(lse, np.asarray(jlse).reshape(b, h, s))
    got = tflash.flash_backward(_t(q), _t(k), _t(v), out, lse, _t(g),
                                causal=causal, scale=scale)
    for x, y in zip(got, want):
        _close(x, y)


@pytest.mark.parametrize("grid", [8, 14])
def test_k9_relpos_flash_matches_pallas(grid):
    """K9's twins == `relpos_flash_fwd_lse` and `relpos_flash_bwd` (Pallas,
    interpret mode): out, LSE, dq, dk, dv and both table gradients. 14 x 14
    is SAM's window, whose S = 196 takes one block of 196 in JAX."""
    rng = np.random.default_rng(1)
    b, h, d = 2, 2, 16
    s, hw = grid * grid, (grid, grid)
    q, k, v, g = (_randn(rng, b, s, h, d) for _ in range(4))
    rph = _randn(rng, 2 * grid - 1, d) * 0.3
    rpw = _randn(rng, 2 * grid - 1, d) * 0.3
    scale = 1.0 / math.sqrt(d)
    jx = [jnp.asarray(x) for x in (q, k, v, rph, rpw)]
    jrh, jrw = jrel.relpos_terms(jx[0], jx[3], jx[4], hw)
    jout, jlse = jrel.relpos_flash_fwd_lse(*jx[:3], jrh, jrw, hw, scale)
    want = jrel.relpos_flash_bwd(*jx, jout, jlse, jnp.asarray(g), hw, scale)

    tx = [_t(x) for x in (q, k, v, rph, rpw)]
    rh, rw = trel.relpos_terms_contiguous(tx[0], tx[3], tx[4], hw)
    out, lse = trel.relpos_flash_fwd_lse(*tx[:3], rh, rw, hw, scale)
    _close(out, jout)
    _close(lse, np.asarray(jlse).reshape(b, h, s))
    got = trel.relpos_flash_bwd(*tx, out, lse, _t(g), hw, scale)
    assert len(got) == len(want) == 5
    for x, y in zip(got, want):
        _close(x, y)


def test_k9_table_gradients_only_when_asked():
    rng = np.random.default_rng(2)
    q, k, v, g = (_t(_randn(rng, 1, 16, 2, 8)) for _ in range(4))
    rph, rpw = _t(_randn(rng, 7, 8)), _t(_randn(rng, 7, 8))
    got = trel.relpos_vjp(q, k, v, rph, rpw, (4, 4), g, (False, True))
    assert got[3] is None and got[4].shape == rpw.shape


# ---------------------------------------------------------------------------
# every autograd Function of the slice, in float64
# ---------------------------------------------------------------------------

def _f64(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape)).requires_grad_()


FUNCTIONS = {
    "flash_attention_trainable causal": lambda rng: (
        lambda q, k, v: tflash.flash_attention_trainable(q, k, v, True, 0.3),
        [_f64(rng, 2, 9, 2, 8) for _ in range(3)]),
    "flash_attention_trainable": lambda rng: (
        lambda q, k, v: tflash.flash_attention_trainable(q, k, v, False, 0.3),
        [_f64(rng, 1, 7, 2, 8) for _ in range(3)]),
    "relpos_flash_attention": lambda rng: (
        lambda q, k, v, a, b: trel.relpos_flash_attention(q, k, v, a, b,
                                                          (3, 2)),
        [_f64(rng, 2, 6, 2, 8) for _ in range(3)]
        + [_f64(rng, 5, 8), _f64(rng, 3, 8)]),
    "sam_window_attention_fused": lambda rng: (
        lambda qkv, a, b: tsam.sam_window_attention_fused(qkv, a, b, (3, 3),
                                                          2),
        [_f64(rng, 2, 9, 48), _f64(rng, 5, 8), _f64(rng, 5, 8)]),
    "sam_attention_with_relpos": lambda rng: (
        lambda q, k, v, a, b: tsam.sam_attention_with_relpos(q, k, v, a, b,
                                                             (3, 3)),
        [_f64(rng, 2, 9, 2, 8) for _ in range(3)]
        + [_f64(rng, 5, 8), _f64(rng, 5, 8)]),
    "grouped_plain_attention_trainable": lambda rng: (
        tattn.grouped_plain_attention_trainable,
        [_f64(rng, 2, 7, 2, 8) for _ in range(3)]),
    "prefill_attention_trainable": lambda rng: (
        lambda q, k, v: tattn.prefill_attention_trainable(q, k, v, 2, 0.3),
        [_f64(rng, 2, 7, 16) for _ in range(3)]),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_autograd_function_gradcheck(name):
    fn, inputs = FUNCTIONS[name](np.random.default_rng(3))
    assert torch.autograd.gradcheck(fn, inputs)


# ---------------------------------------------------------------------------
# boxes and losses
# ---------------------------------------------------------------------------

def _boxes(rng, *lead):
    c = rng.uniform(0.2, 0.8, lead + (2,))
    wh = rng.uniform(0.05, 0.4, lead + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


def test_boxes_match_jax():
    rng = np.random.default_rng(4)
    a, b = _boxes(rng, 3, 5), _boxes(rng, 3, 5)
    b[0, 0] = a[0, 0]                               # identical
    b[0, 1, 2:] = 0.0                               # degenerate
    ja, jb = jboxes.box_cxcywh_to_xyxy(a), jboxes.box_cxcywh_to_xyxy(b)
    ta, tb = tboxes.box_cxcywh_to_xyxy(_t(a)), tboxes.box_cxcywh_to_xyxy(
        _t(b))
    _close(ta, ja, 1e-6)
    _close(tboxes.box_xyxy_to_cxcywh(ta), jboxes.box_xyxy_to_cxcywh(ja),
           1e-6)
    _close(tboxes.box_area(ta), jboxes.box_area(ja), 1e-6)
    _close(tboxes.box_iou_pairwise(ta, tb), jboxes.box_iou_pairwise(ja, jb),
           1e-6)
    _close(tboxes.generalized_box_iou(ta, tb),
           jboxes.generalized_box_iou(ja, jb), 1e-6)
    _close(tboxes.generalized_box_iou_loss(ta, tb),
           jboxes.generalized_box_iou_loss(ja, jb), 1e-6)


@pytest.mark.parametrize("objectness", [True, False])
def test_losses_match_jax(objectness):
    """The loss dict, with a sample whose phrases are all masked and labels
    that are mostly ignore_index."""
    rng = np.random.default_rng(5)
    b, t, p, length, vocab = 2, 3, 4, 11, 17
    logits = _randn(rng, b, length, vocab) * 3
    labels = rng.integers(0, vocab, (b, length))
    labels[:, :6] = -100
    labels[1, 8:] = -100
    pred, gt = _boxes(rng, b, t, p), _boxes(rng, b, t, p)
    obj = _randn(rng, b, t, p) * 4
    gt_obj = (rng.uniform(size=(b, t, p)) < 0.6).astype(np.float32)
    mask = np.array([[1, 1, 0, 0], [0, 0, 0, 0]], np.float32)
    kw = dict(ce_weight=0.7, giou_weight=1.3, objectness_weight=0.9,
              use_temp_objectness=objectness, ignore_index=-100)
    want = jlosses.grove_total_loss(logits, labels, pred, obj, gt, gt_obj,
                                    mask, **kw)
    got = tlosses.grove_total_loss(_t(logits), _t(labels), _t(pred),
                                   _t(obj), _t(gt), _t(gt_obj), _t(mask),
                                   **kw)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], 1e-5)
    none = tlosses.grove_box_losses(_t(pred), _t(obj), _t(gt), _t(gt_obj),
                                    torch.zeros(b, p))
    assert all(float(v) == 0.0 for v in none.values())
    all_ignored = np.full_like(labels, -100)
    assert float(tlosses.cross_entropy_lm_loss(_t(logits),
                                               _t(all_ignored))) == 0.0


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_matches_optax():
    """Five steps with warmup (2 steps), decay to 0 at step 5, weight decay
    and clipping at a norm the gradients cross both ways."""
    rng = np.random.default_rng(6)
    cfg = tstep.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                                weight_decay=0.1, grad_clip=1.0)
    jcfg = jstep.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                                 weight_decay=0.1, grad_clip=1.0)
    init = {"a": _randn(rng, 4, 3), "b": _randn(rng, 5)}
    grads = [{k: _randn(rng, *v.shape) * s for k, v in init.items()}
             for s in (0.1, 2.0, 0.05, 3.0, 0.2)]
    opt = jstep.make_optimizer(init, jcfg)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jp)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in init.items()}
    adamw = tstep.make_optimizer(params, cfg)
    norms = []
    for count, g in enumerate(grads):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = _t(g[k])
        norms.append(float(adamw.global_norm()))
        adamw.step()
        assert adamw.schedule(count) == pytest.approx(
            float(jstep.warmup_decay_schedule(jcfg)(count)), abs=1e-9)
        for k in init:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    assert min(norms) < 1.0 < max(norms)


# ---------------------------------------------------------------------------
# the tiny slice
# ---------------------------------------------------------------------------

def _slice_config():
    """GroveConfig.tiny() with a SAM of 4 blocks, globals 1 and 3 (so a
    windowed and a global block sit after adapter 0), and 121 text tokens
    (121 + 7 spliced = 128, a multiple of 64: the LLaMA takes K4)."""
    cfg = GroveConfig.tiny()
    sam = dataclasses.replace(cfg.sam_enc, depth=4,
                              global_attn_indexes=(1, 3))
    return dataclasses.replace(cfg, sam_enc=sam, max_seq_len=121)


def _sample(cfg, rng):
    t, p = cfg.num_frames, cfg.max_phrases
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    return {"frames_clip": rng.integers(0, 256, (t, c, c, 3), np.uint8),
            "frames_sam": rng.integers(0, 256, (t, s, s, 3), np.uint8),
            "caption": CAPTION, "tokens_positive": SPANS,
            "gt_boxes": _boxes(rng, t, p),
            "gt_objectness": (rng.uniform(size=(t, p)) < 0.7).astype(
                np.float32)}


def _named(tree, cfg):
    """A JAX param-shaped tree (None holes filled with zeros of `like`) as
    reference-named numpy arrays."""
    return {k: np.asarray(v) for k, v in to_torch_state_dict(tree,
                                                             cfg).items()}


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny model (zero leaves refilled), its port twin, one batch,
    and the JAX package's two training steps and step-1 gradients."""
    cfg = _slice_config()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    batch, _ = build_batch([_sample(cfg, np.random.default_rng(1))],
                           MockTokenizer(), cfg, np.random.default_rng(2))
    assert batch["input_ids"].shape == (1, 128)
    assert batch["phrase_mask"].sum() == 3

    ocfg = jstep.OptimizerConfig(warmup_steps=1)
    trainable, frozen = jstep.partition_params(
        params, jstep.trainable_mask(params, ocfg))
    optimizer = jstep.make_optimizer(trainable, ocfg)
    state = optimizer.init(trainable)
    step = jax.jit(jstep.make_train_step(jmodel, optimizer))

    def loss(tr):
        return jmodel.apply({"params": jstep.combine_params(tr, frozen)},
                            batch, method=JaxGrove.forward_train)["loss"]

    grads = jax.jit(jax.grad(loss))(trainable)
    metrics = []
    for _ in range(2):
        trainable, state, m = step(trainable, frozen, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    zeros = jax.tree.map(jnp.zeros_like, frozen)
    return {"cfg": cfg, "params": params, "batch": batch,
            "metrics": metrics,
            "grads": _named(jstep.combine_params(grads, zeros), cfg),
            "after": _named(jstep.combine_params(trainable, frozen), cfg)}


def _port_model(cfg, params):
    model = GroveModel(port_config(cfg), device="cpu", dtype=torch.float32)
    load_reference_state_dict(model, to_torch_state_dict(params, cfg))
    return model


def _jax_trainable_names(params, cfg, ocfg):
    mask = jstep.trainable_mask(params, ocfg)
    ones = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m),
                                             np.float32), mask, params)
    return {k for k, v in to_torch_state_dict(ones, cfg).items()
            if np.all(np.asarray(v) == 1.0)}


@pytest.mark.parametrize("flip", [None, "train_embeddings",
                                  "train_mask_decoder", "freeze",
                                  "full_llm"])
def test_trainable_set_equals_jax(tiny, flip):
    """The port's trainable set == the JAX `trainable_mask` mapped through
    `to_torch_state_dict`, at the defaults and with one flag flipped."""
    cfg, params = tiny["cfg"], tiny["params"]
    kw = {} if flip is None else {
        flip: not getattr(jstep.OptimizerConfig(), flip)}
    want = _jax_trainable_names(params, cfg, jstep.OptimizerConfig(**kw))
    model = _port_model(cfg, params)
    mask = tstep.trainable_mask(model, tstep.OptimizerConfig(**kw))
    assert {n for n, m in mask.items() if m} == want
    trainable = tstep.partition_params(model, mask)
    assert all(p.requires_grad == (n in trainable)
               for n, p in model.named_parameters())


def test_tiny_slice_train_steps_match_jax(tiny):
    """Two steps of the port's `make_train_step` == the JAX package's: loss
    terms, step-1 gradients of every trainable tensor, and the trainable
    parameters after step 2."""
    cfg = tiny["cfg"]
    model = _port_model(cfg, tiny["params"])
    ocfg = tstep.OptimizerConfig(warmup_steps=1)
    params = tstep.partition_params(model, tstep.trainable_mask(model, ocfg))
    step = tstep.make_train_step(model, tstep.make_optimizer(params, ocfg))
    batch = tstep.batch_to_device(tiny["batch"], "cpu")
    grads = None
    for i, want in enumerate(tiny["metrics"]):
        got = step(batch)
        assert set(got) == set(want)
        for key, w in want.items():
            assert abs(float(got[key]) - w) <= LOSS_REL * abs(w), (i, key)
        if i == 0:
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)) for n, p in params.items()}
    sam_blocks = [n for n in params if ".image_encoder.adapters." in n]
    assert sam_blocks and all(float(grads[n].abs().max()) > 0
                              for n in sam_blocks)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), tiny["grads"][name],
                                   rtol=SLICE_TOL, atol=SLICE_TOL,
                                   err_msg=name)
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), tiny["after"][name],
                                   rtol=0, atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("train_clip", [False, True])
def test_encode_video_gradients(tiny, train_clip):
    """The projector always gets a gradient; the CLIP tower none, unless
    `train_clip_adapters` is set: then every tower gradient matches JAX's
    (the tiny tower's S = 5 takes the plain attention, as on the TPU;
    K3's recompute backward has its own gradcheck)."""
    cfg = dataclasses.replace(tiny["cfg"], train_clip_adapters=train_clip)
    params = tiny["params"]
    frames = tiny["batch"]["frames_clip"]
    rng = np.random.default_rng(7)
    model = _port_model(cfg, params)
    out, _ = model.encode_video(_t(frames))
    cot = _randn(rng, *out.shape)
    (out * _t(cot)).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert float(grads["model.mm_projector.0.weight"].abs().max()) > 0
    tower = [n for n in grads if n.startswith("model.vision_tower.")]
    if not train_clip:
        assert all(grads[n] is None for n in tower)
        return
    jmodel = JaxGrove(cfg, dtype=jnp.float32)

    def f(p):
        emb, _ = jmodel.apply({"params": p}, frames,
                              method=JaxGrove.encode_video)
        return jnp.sum(emb * cot)

    want = _named(jax.grad(f)(params), cfg)
    assert tower
    for n in tower:                 # None: the parameter feeds no token
        got = np.zeros_like(want[n]) if grads[n] is None else grads[n]
        np.testing.assert_allclose(got, want[n], rtol=SLICE_TOL,
                                   atol=SLICE_TOL, err_msg=n)
    assert all(grads[n] is not None for n in tower if "adapters" in n)


# ---------------------------------------------------------------------------
# the grad guard and the padded int8 GEMM
# ---------------------------------------------------------------------------

def test_grad_guard_raises_only_when_a_gradient_would_be_lost():
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    with pytest.raises(RuntimeError, match="has no backward"):
        _kernels.check_no_grad([y, x])
    _kernels.check_no_grad([y, y])
    with torch.no_grad():
        _kernels.check_no_grad([x])
    with torch.inference_mode():
        _kernels.check_no_grad([x])


def _int_mm_emulated(a, b):
    """`torch._int_mm`'s shape contract, exact on the CPU."""
    assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
    assert b.t().is_contiguous()
    return torch.matmul(a.double(), b.double()).to(torch.int32)


@pytest.mark.parametrize("m,k,n,room", [(2, 64, 37, True),
                                        (40, 64, 37, False),
                                        (5, 100, 37, True),
                                        (33, 64, 32, True)])
def test_int8_matmul_pads_to_the_card_shapes(monkeypatch, m, k, n, room):
    """The card's branch of `int8_matmul` (the CPU taking it, with
    `torch._int_mm` emulated under its shape contract) is exact at shapes
    it refuses: M <= 16, K and N no multiple of 8, with b's padded storage
    (`column_major`) or without room (a copy per call)."""
    monkeypatch.setattr(_kernels, "on_cpu", lambda *t: False)
    monkeypatch.setattr(torch, "_int_mm", _int_mm_emulated)
    rng = np.random.default_rng(8)
    a = _t(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = _t(rng.integers(-127, 128, (k, n)).astype(np.int8))
    b = tint8.column_major(w) if room else w.t().contiguous().t()
    assert torch.equal(b, w) and b.t().is_contiguous()
    got = tint8.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, torch.matmul(a.double(), w.double()).to(
        torch.int32))
