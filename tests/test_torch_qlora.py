"""The QLoRA fine-tune recipe of the port (LoRA on q/v, a frozen int4 LLM
whose weight views are rebuilt in the backward, bf16 Adam moments,
stochastic rounding, remat) against the JAX package on the CPU, fp32,
small sizes.

* `Int4Linear`'s card branch (the CPU taking it through the `_on_card`
  seam) == JAX's `Int4Dense` TPU branch (`_backend` patched), keeps no
  (K, N) float view for the backward, and its autograd Function passes a
  float64 `gradcheck`;
* `adamw_bf16` == the JAX `adamw_bf16` over 5 steps on bf16 parameters,
  within 1 bf16 ULP; `apply_updates_sr` is unbiased, exact on sums bf16
  holds, and deterministic under a seed;
* remat leaves the gradients as they are (1e-6);
* the LoRA leaves of a JAX tree carry over (`jax_lora_state_dict`,
  `load_jax_quantized_llama`), and the full-width QLoRA trainable count is
  JAX's 581.7 M (counted on the meta device);
* the tiny slice: JAX `init_grove_params(lora_r=4)`, `quantize(bits=4)`,
  `make_train_step` with bf16 moments over 2 steps == the port's (its
  model with remat), at S = 201, a ragged length, so the port's pass takes
  K10's twin with the recompute backward: loss terms within 1e-4
  relative, step-1 gradients within 2e-3, trainables after step 2 within
  1e-4, the trainable set equal to JAX's `trainable_mask`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from grove_tpu.api.model import GroveForCausalLM as JaxLM  # noqa: E402
from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.data.collate import build_batch  # noqa: E402
from grove_tpu.models import layers as jlayers  # noqa: E402
from grove_tpu.models.grove import GroveModel as JaxGrove  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.ops import quant as jquant  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu.train import lowmem as jlowmem  # noqa: E402
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch import config as tconfig  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    jax_lora_state_dict, load_jax_quantized_llama, load_reference_state_dict)
from grove_tpu_torch.models import layers as tlayers  # noqa: E402
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.ops import quant as tquant  # noqa: E402
from grove_tpu_torch.train import lowmem as tlowmem  # noqa: E402
from grove_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_parity import _perturb_zeros, port_config  # noqa: E402

LOSS_REL = 1e-4         # loss terms, relative
SLICE_TOL = 2e-3        # step-1 gradients (the parity suite's tolerance)
PARAM_TOL = 1e-4        # trainable parameters after step 2, absolute
CAPTION = "a man slices bread on a wooden board"
SPANS = [(0, 5), (13, 18), (22, 36)]
TEXT_TOKENS = 194       # + 7 spliced video tokens = S = 201


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 ULP at |x| (2^(e - 7) for x in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


# ---------------------------------------------------------------------------
# Int4Linear's recomputed view
# ---------------------------------------------------------------------------

def _int4_pair(rng, k=256, n=128):
    kernel = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    lin = tlayers.Int4Linear.from_kernel(_t(kernel), 128)
    q4p, scale = jquant.quantize_kernel_int4(kernel, 128)
    return lin, {"params": {"kernel_q4p": jnp.asarray(q4p),
                            "scale": jnp.asarray(scale)}}


def test_int4_card_branch_matches_jax_and_saves_no_view(monkeypatch):
    """At 64 rows the card's branch (the view Function) == JAX's TPU
    branch (`jax.checkpoint(viewdot)`), value and dx, and autograd holds
    no (K, N) float tensor: only x-independent int8 bytes and scales."""
    monkeypatch.setattr(tlayers, "_on_card", lambda x: True)
    monkeypatch.setattr(jlayers, "_backend", lambda: "tpu")
    rng = np.random.default_rng(0)
    lin, variables = _int4_pair(rng)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    dy = rng.normal(size=(64, 128)).astype(np.float32)
    jmod = jlayers.Int4Dense(128, group=128, dtype=jnp.float32)

    def f(xx):
        return jnp.sum(jmod.apply(variables, xx) * dy)

    want_y = jmod.apply(variables, jnp.asarray(x))
    want_dx = jax.grad(f)(jnp.asarray(x))
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    xt = _t(x).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = lin(xt)
    (y * _t(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=1e-5,
                               atol=1e-5)
    assert saved and not any(dt.is_floating_point and shape == (256, 128)
                             for shape, dt in saved), saved


def test_int4_view_function_gradcheck():
    rng = np.random.default_rng(1)
    lin, _ = _int4_pair(rng, 256, 8)
    x = torch.from_numpy(rng.normal(size=(5, 256))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a: tlayers._Int4ViewMatmul.apply(a, lin.kernel_q4p,
                                                lin.scale.double(), 128),
        (x,))


# ---------------------------------------------------------------------------
# bf16 moments and stochastic rounding
# ---------------------------------------------------------------------------

def test_adamw_bf16_matches_jax():
    """Five steps on bf16 parameters (bf16 gradients, plain adds): warmup,
    decay, weight decay, and a clipping norm the gradients cross both
    ways; parameters and both moments within 1 bf16 ULP of JAX's."""
    rng = np.random.default_rng(2)
    cfg = tstep.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                                weight_decay=0.1, grad_clip=1.0,
                                moment_dtype="bf16")
    jcfg = jstep.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                                 weight_decay=0.1, grad_clip=1.0,
                                 moment_dtype="bf16")
    init = {"a": rng.normal(size=(4, 3)), "b": rng.normal(size=(64,))}
    grads = [{k: rng.normal(size=v.shape) * s for k, v in init.items()}
             for s in (0.1, 2.0, 0.05, 3.0, 0.2)]
    bf = jnp.bfloat16
    jp = {k: jnp.asarray(v, bf) for k, v in init.items()}
    opt = jstep.make_optimizer(jp, jcfg)
    state = opt.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(np.asarray(
        v, np.float32)).to(torch.bfloat16)) for k, v in jp.items()}
    adamw = tstep.make_optimizer(params, cfg)
    assert isinstance(adamw, tlowmem.AdamWBf16)

    def f32(x):
        return np.array(jnp.asarray(x, jnp.float32))

    for g in grads:
        jg = {k: jnp.asarray(v, bf) for k, v in g.items()}
        upd, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(f32(jg[k])).to(torch.bfloat16)
        adamw.step()
        adam = state[1]
        for k in init:
            for got, want in ((params[k], jp[k]), (adamw.mu[k], adam.mu[k]),
                              (adamw.nu[k], adam.nu[k])):
                got = got.detach().float().numpy()
                want = f32(want)
                assert got.dtype == want.dtype
                assert np.all(np.abs(got - want) <= _bf16_ulp(want)), k


def _sr_case(generator, x, u):
    p = {"p": torch.nn.Parameter(x.clone())}
    tlowmem.apply_updates_sr(p, {"p": u}, generator)
    return p["p"].detach()


def test_apply_updates_sr_is_unbiased():
    """4096 draws of p + u for p = +-1.5 in bf16 and u a quarter, a tenth,
    0.9 and -0.3 of its ULP: every result is one of the two neighbours,
    and the mean is p + u within 4 sigma of the rounding's Bernoulli
    spread."""
    ulp = 2.0 ** -7                 # bf16's ULP on [1, 2)
    gen = torch.Generator().manual_seed(0)
    for p in (1.5, -1.5):
        for frac in (0.25, 0.1, 0.9, -0.3):
            x = torch.full((4096,), p, dtype=torch.bfloat16)
            u = torch.full((4096,), frac * ulp)
            got = _sr_case(gen, x, u).float().numpy()
            lo = p + np.floor(frac) * ulp
            assert set(np.unique(got)) <= {lo, lo + ulp}
            share = frac - np.floor(frac)
            sigma = ulp * np.sqrt(share * (1 - share) / 4096)
            assert abs(float(got.mean()) - (p + frac * ulp)) <= 4 * sigma


def test_apply_updates_sr_is_exact_on_representable_sums():
    """p + u that bf16 holds comes back exactly (values within a few
    binades of each other, so the fp32 difference u is exact); a zero
    update leaves p; a non-bf16 parameter takes a plain add."""
    gen = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(3)

    def draw():
        v = rng.uniform(0.5, 4.0, 2048) * rng.choice([-1.0, 1.0], 2048)
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)

    x, y = draw(), draw()
    assert torch.equal(_sr_case(gen, x, y.float() - x.float()), y)
    assert torch.equal(_sr_case(gen, x, torch.zeros(2048)), x)
    p32 = torch.ones(3)
    assert torch.equal(_sr_case(gen, p32, torch.full((3,), 1e-3)),
                       p32 + 1e-3)


def test_apply_updates_sr_is_deterministic_for_a_seed():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(512,)).astype(np.float32)).to(
        torch.bfloat16)
    u = torch.from_numpy(rng.normal(size=(512,)).astype(np.float32)) * 1e-3
    a = _sr_case(torch.Generator().manual_seed(7), x, u)
    b = _sr_case(torch.Generator().manual_seed(7), x, u)
    c = _sr_case(torch.Generator().manual_seed(8), x, u)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# the tiny QLoRA slice
# ---------------------------------------------------------------------------

def _lora_config(lora_r=4):
    cfg = GroveConfig.tiny()
    return dataclasses.replace(
        cfg, max_seq_len=TEXT_TOKENS,
        llama=dataclasses.replace(cfg.llama, lora_r=lora_r))


def _sample(cfg, rng):
    t, p = cfg.num_frames, cfg.max_phrases
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (t, p, 2)),
                            rng.uniform(0.05, 0.4, (t, p, 2))], -1)
    return {"frames_clip": rng.integers(0, 256, (t, c, c, 3), np.uint8),
            "frames_sam": rng.integers(0, 256, (t, s, s, 3), np.uint8),
            "caption": CAPTION, "tokens_positive": SPANS,
            "gt_boxes": boxes.astype(np.float32),
            "gt_objectness": (rng.uniform(size=(t, p)) < 0.7).astype(
                np.float32)}


def _mask_over(tree, qmask):
    """A 0/1 numpy tree over the float tree `tree`: 1 where the quantized
    tree's mask `qmask` marks the same path trainable, 0 elsewhere (a
    kernel the quantization replaced)."""
    out = {}
    for k, v in tree.items():
        sub = qmask.get(k) if isinstance(qmask, dict) else None
        if isinstance(v, dict):
            out[k] = _mask_over(v, sub if isinstance(sub, dict) else {})
        else:
            out[k] = np.full(np.shape(v), float(bool(sub)), np.float32)
    return out


@pytest.fixture(scope="module")
def qlora():
    """The JAX tiny model with LoRA (zero leaves refilled, so lora_B is
    nonzero), quantized to int4; one batch; JAX's step-1 gradients, two
    bf16-moment steps, and the trainable set as port names."""
    cfg = _lora_config()
    _, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                     dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    jlm = JaxLM(cfg, JaxGrove(cfg, dtype=jnp.float32),
                {"params": params}).quantize(bits=4)
    qparams = jlm.variables["params"]
    batch, _ = build_batch([_sample(cfg, np.random.default_rng(1))],
                           MockTokenizer(), cfg, np.random.default_rng(2))
    assert batch["input_ids"].shape == (1, TEXT_TOKENS + 7)
    assert batch["phrase_mask"].sum() == 3

    ocfg = jstep.OptimizerConfig(warmup_steps=1, moment_dtype="bf16")
    mask = jstep.trainable_mask(qparams, ocfg)
    trainable, frozen = jstep.partition_params(qparams, mask)
    optimizer = jstep.make_optimizer(trainable, ocfg)
    state = optimizer.init(trainable)
    assert isinstance(state[1], jlowmem.ScaleByAdamCompactState)
    step = jax.jit(jstep.make_train_step(jlm.model, optimizer))

    def loss(tr):
        return jlm.model.apply({"params": jstep.combine_params(tr, frozen)},
                               batch, method=JaxGrove.forward_train)["loss"]

    grads = jax.jit(jax.grad(loss))(trainable)
    metrics = []
    for _ in range(2):
        trainable, state, m = step(trainable, frozen, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    ones = _mask_over(params, mask)
    names = {k for k, v in {**to_torch_state_dict(ones, cfg),
                            **jax_lora_state_dict(ones)}.items()
             if np.all(np.asarray(v) == 1.0)}

    def named(tree):
        flat = {}
        for k, v in {**to_torch_state_dict(tree, cfg),
                     **jax_lora_state_dict(tree)}.items():
            flat[k] = np.asarray(v)
        return flat

    zeros = jax.tree.map(jnp.zeros_like, frozen)
    full_grads = jstep.combine_params(grads, zeros)
    after = jstep.combine_params(trainable, frozen)
    return {"cfg": cfg, "params": params, "qparams": qparams,
            "batch": batch, "metrics": metrics, "names": names,
            "grads": named(_float_leaves(full_grads, params)),
            "after": named(_float_leaves(after, params))}


def _float_leaves(tree, like):
    """`tree` (a quantized-layout tree) on the float layout of `like`: the
    leaves both share, and `like`'s own leaves where quantization replaced
    them (never trainable, so never compared)."""
    out = {}
    for k, v in like.items():
        sub = tree.get(k) if isinstance(tree, dict) else None
        if isinstance(v, dict):
            out[k] = _float_leaves(sub if isinstance(sub, dict) else {}, v)
        else:
            out[k] = np.asarray(sub if sub is not None and not isinstance(
                sub, dict) else v)
    return out


def _port_qlora(cfg, params, qparams, remat=True):
    """The port's twin: float weights and LoRA from the JAX tree, then
    quantized in place, the JAX tree's int4 bytes and LoRA carried."""
    model = GroveModel(port_config(cfg), remat=remat, device="cpu",
                       dtype=torch.float32)
    load_reference_state_dict(model, {**to_torch_state_dict(params, cfg),
                                      **jax_lora_state_dict(params)})
    tquant.quantize_llama_(model, 4)
    load_jax_quantized_llama(model, qparams)
    return model


def test_lora_leaves_carry_over(qlora):
    params, qparams = qlora["params"], qlora["qparams"]
    sd = jax_lora_state_dict(params)
    lora = params["llama"]["layers_0"]["self_attn"]["q_proj_lora"]
    a = sd["model.layers.0.self_attn.q_proj_lora.lora_A.weight"]
    np.testing.assert_array_equal(a.numpy(),
                                  np.asarray(lora["lora_A"]["kernel"]).T)
    assert len(sd) == 4 * qlora["cfg"].llama.num_layers
    model = _port_qlora(qlora["cfg"], params, qparams)
    assert isinstance(model.model.layers[0].self_attn.q_proj,
                      tlayers.Int4Linear)
    for name, p in model.named_parameters():
        if "_lora." in name:
            assert torch.equal(p.detach(), sd[name]), name
    short = jax.tree.map(lambda x: x, qparams)
    del short["llama"]["layers_1"]["self_attn"]["v_proj_lora"]
    with pytest.raises(KeyError, match="one side only"):
        load_jax_quantized_llama(model, short)


def test_full_width_qlora_trainable_count():
    """`GroveConfig()` with lora_r = 8, quantized to int4 on the meta
    device: the JAX recipe's trainable set, 708,589,557 - 131,100,672
    (lm_head, now int8 and frozen) + 4,194,304 (LoRA) parameters."""
    cfg = tconfig.GroveConfig()
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama,
                                                             lora_r=8))
    model = GroveModel(cfg, device="meta", dtype=torch.bfloat16)
    tquant.quantize_llama_(model, 4)
    mask = tstep.trainable_mask(model, tstep.OptimizerConfig(
        moment_dtype="bf16"))
    n = sum(p.numel() for name, p in model.named_parameters() if mask[name])
    assert n == 708_589_557 - 131_100_672 + 4_194_304 == 581_683_189
    assert not any(mask[n] for n, _ in model.named_parameters()
                   if n.startswith("lm_head."))


def test_remat_leaves_gradients_equal(qlora):
    """The QLoRA model with and without remat: every trainable gradient
    within 1e-6."""
    cfg, batch = qlora["cfg"], qlora["batch"]
    grads = []
    for remat in (False, True):
        model = _port_qlora(cfg, qlora["params"], qlora["qparams"], remat)
        params = tstep.partition_params(model, tstep.trainable_mask(
            model, tstep.OptimizerConfig(moment_dtype="bf16")))
        model.forward_train(tstep.batch_to_device(batch, "cpu"))[
            "loss"].backward()
        grads.append({n: p.grad for n, p in params.items()})
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[0].items():
        if g is None:
            assert grads[1][name] is None, name
            continue
        np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_tiny_qlora_steps_match_jax(qlora):
    cfg = qlora["cfg"]
    model = _port_qlora(cfg, qlora["params"], qlora["qparams"])
    ocfg = tstep.OptimizerConfig(warmup_steps=1, moment_dtype="bf16")
    params = tstep.partition_params(model, tstep.trainable_mask(model, ocfg))
    assert set(params) == qlora["names"]
    assert any("_lora." in n for n in params)
    step = tstep.make_train_step(model, tstep.make_optimizer(params, ocfg))
    batch = tstep.batch_to_device(qlora["batch"], "cpu")
    grads = None
    for i, want in enumerate(qlora["metrics"]):
        got = step(batch)
        assert set(got) == set(want)
        for key, w in want.items():
            assert abs(float(got[key]) - w) <= LOSS_REL * abs(w), (i, key)
        if i == 0:
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)) for n, p in params.items()}
    lora_b = [n for n in grads if "lora_B" in n]
    assert lora_b and all(float(grads[n].abs().max()) > 0 for n in lora_b)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), qlora["grads"][name],
                                   rtol=SLICE_TOL, atol=SLICE_TOL,
                                   err_msg=name)
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), qlora["after"][name],
                                   rtol=0, atol=PARAM_TOL, err_msg=name)
