"""The port's data, tensor and fully sharded parallel steps, each run by
spawned gloo processes on the CPU (`grove_tpu_torch.parallel.launch`
starting `grove_tpu_torch.parallel.workers`), against the unsharded step
in this process and the JAX package, at `GroveConfig.tiny()` in fp32.

* Data parallelism: two ranks whose local batches have different
  valid-token and box counts take two steps; their losses and updated
  parameters equal the single-process step on the concatenated batch
  (losses within 1e-5 relative, parameters within 2e-5, the first step's
  gradients within 1e-4 of their max-abs), and the first
  loss equals the JAX `make_train_step` on that global batch within
  rtol = atol = 2e-3: the counts are summed across ranks before they
  divide, as JAX's one SPMD loss over the global batch.
* Tensor parallelism over 2 ranks (the tiny vocabulary, which the rule
  drops, and one of 136 rows, sharded), TP x FSDP x sequence parallelism
  over 4 ranks (`tests/test_multichip.py:75`), and ZeRO-2 moments over 2
  ranks: the same step as the unsharded one, within the same tolerances.

Each launch has its own time limit (`LAUNCH_S`) and kills its processes on
failure; the workers import no JAX (they are modules of the port).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_reference_state_dict)
from grove_tpu_torch.data.collate import build_batch  # noqa: E402
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.parallel.launch import launch  # noqa: E402
from grove_tpu_torch.parallel.workers import grove_config  # noqa: E402
from grove_tpu_torch.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_parity import _perturb_zeros  # noqa: E402

TOL = 2e-3               # port vs JAX (the parity suite's)
LOSS_REL = 1e-5          # sharded vs unsharded loss terms, fp32
PARAM_TOL = 2e-5         # sharded vs unsharded parameters after 2 steps
GRAD_TOL = 1e-4          # sharded vs unsharded gradients, of max-abs
LAUNCH_S = 240           # each launch's own time limit
OPT = {"warmup_steps": 0}
SEQ_EVEN = {"max_seq_len": 161}       # 161 + 7 = 168 tokens: S % 2 == 0


def _sample(cfg, rng, caption, spans, visible):
    t, p = cfg.num_frames, cfg.max_phrases
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    return {"frames_clip": rng.integers(0, 256, (t, c, c, 3), np.uint8),
            "frames_sam": rng.integers(0, 256, (t, s, s, 3), np.uint8),
            "caption": caption, "tokens_positive": spans,
            "gt_boxes": rng.uniform(0.2, 0.6, (t, p, 4)).astype(np.float32),
            "gt_objectness": (rng.uniform(size=(t, p)) < visible).astype(
                np.float32)}


def _local_batches(cfg):
    """Two one-row batches with different CE targets, phrases and boxes."""
    tok = MockTokenizer()
    a, _ = build_batch([_sample(cfg, np.random.default_rng(1),
                                "a man slices bread on a wooden board",
                                [(0, 5), (13, 18), (22, 36)], 0.7)], tok, cfg,
                       np.random.default_rng(2))
    b, _ = build_batch([_sample(cfg, np.random.default_rng(3), "a dog runs",
                                [(0, 5)], 0.3)], tok, cfg,
                       np.random.default_rng(4))
    return [a, b]


def _concat(batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX tiny weights (zero leaves refilled) saved as the port's
    state dict, the JAX config."""
    root = tmp_path_factory.mktemp("dist")
    cfg = GroveConfig.tiny()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    model = GroveModel(grove_config(), device="cpu", dtype=torch.float32)
    load_reference_state_dict(model, to_torch_state_dict(params, cfg))
    weights = root / "tiny.pt"
    torch.save(model.state_dict(), weights)
    return {"root": root, "cfg": cfg, "jmodel": jmodel, "params": params,
            "weights": str(weights), "model": model}


def _reference(weights, config, batch, steps=2):
    """The unsharded port step on `batch`: each step's loss terms and the
    trainable parameters after the last."""
    from grove_tpu_torch.models.grove import GroveModel as TModel
    model = TModel(grove_config(config), device="cpu", dtype=torch.float32)
    model.load_state_dict(torch.load(weights, weights_only=True))
    ocfg = tstep.OptimizerConfig(**OPT)
    params = tstep.partition_params(model, tstep.trainable_mask(model, ocfg))
    step = tstep.make_train_step(model, tstep.make_optimizer(params, ocfg))
    metrics, grads = [], None
    for _ in range(steps):
        out = step(tstep.batch_to_device(batch, "cpu"))
        metrics.append({k: float(v) for k, v in out.items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in params.items()
                     if p.grad is not None}
    return (metrics, {n: p.detach().clone() for n, p in params.items()},
            grads)


def _sharded(root, name, world, weights, batches, **kw):
    """Launch `world` ranks of `workers.train_step`; rank 0's results."""
    bpath, out = root / f"{name}_batches.pt", root / f"{name}_out.pt"
    torch.save(batches, bpath)
    args = dict(weights=weights, batches=str(bpath), out=str(out),
                optimizer=OPT, device="cpu", **kw)
    launch(["-m", "grove_tpu_torch.parallel.workers", "train_step",
            json.dumps(args)], world, timeout=LAUNCH_S)
    return torch.load(out, weights_only=False)


def _assert_same_step(got, want_metrics, want_params, want_grads):
    assert len(got["metrics"]) == len(want_metrics)
    for g, w in zip(got["metrics"], want_metrics):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) <= LOSS_REL * max(1.0, abs(w[k])), (k, g,
                                                                        w)
    assert set(got["params"]) == set(want_params)
    for n, p in want_params.items():
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=n)
    # the first step's gradients: each within GRAD_TOL of its own max-abs,
    # a gradient zero up to rounding within GRAD_TOL of the largest
    assert set(want_grads) <= set(got["grads"])
    for n in set(got["grads"]) - set(want_grads):    # zeros, as optax's
        assert not bool(got["grads"][n].any()), n
    top = max(float(g.abs().max()) for g in want_grads.values())
    for n, g in want_grads.items():
        scale = max(float(g.abs().max()), 1e-3 * top)
        err = float((got["grads"][n] - g).abs().max()) / scale
        assert err <= GRAD_TOL, (n, err)


def test_data_parallel_step_matches_the_global_batch(tiny):
    cfg = grove_config()
    local = _local_batches(cfg)
    counts = [((b["labels"] != -100).sum(), b["phrase_mask"].sum(),
               (b["gt_objectness"] * b["phrase_mask"][:, None]).sum())
              for b in local]
    assert all(x != y for x, y in zip(*counts)), counts
    glob = _concat(local)
    want = _reference(tiny["weights"], None, glob)
    got = _sharded(tiny["root"], "dp", 2, tiny["weights"], local)
    _assert_same_step(got, *want)

    jcfg = jstep.OptimizerConfig(**OPT)
    params = tiny["params"]
    trainable, frozen = jstep.partition_params(
        params, jstep.trainable_mask(params, jcfg))
    opt = jstep.make_optimizer(trainable, jcfg)
    _, _, jm = jax.jit(jstep.make_train_step(tiny["jmodel"], opt))(
        trainable, frozen, opt.init(trainable),
        {k: jnp.asarray(v) for k, v in glob.items()})
    for k, v in jm.items():
        if k.endswith("loss"):
            np.testing.assert_allclose(got["metrics"][0][k], float(v),
                                       rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("vocab", ["tiny", "sharded"])
def test_tensor_parallel_step_matches(tiny, vocab):
    """model = 2, data = 1: the tiny vocabulary of 135 (embed_tokens and
    lm_head replicated: the rule does not divide), or 136 rows (both
    sharded over "model")."""
    config, weights = None, tiny["weights"]
    if vocab == "sharded":
        config = {"llama.extra_vocab_size": 8}
        from grove_tpu_torch.models.grove import init_grove_params as tinit
        model = tinit(grove_config(config), device="cpu", dtype=torch.float32,
                      seed=3)
        weights = str(tiny["root"] / "vocab136.pt")
        torch.save(model.state_dict(), weights)
    glob = _concat(_local_batches(grove_config(config)))
    want = _reference(weights, config, glob)
    got = _sharded(tiny["root"], f"tp_{vocab}", 2, weights, [glob], tp=2,
                   config=config)
    _assert_same_step(got, *want)


def test_tp_fsdp_sequence_parallel_step_matches_replicated(tiny):
    """(data, model) = (2, 2): the TP rules, FSDP over "data" (parameters
    of 256 elements and more) and the LLaMA's residual stream sharded on
    S = 168 over "model"."""
    local = _local_batches(grove_config(SEQ_EVEN))
    assert local[0]["input_ids"].shape[1] % 2 == 0
    want = _reference(tiny["weights"], SEQ_EVEN, _concat(local))
    got = _sharded(tiny["root"], "fsdp_sp", 4, tiny["weights"], local, tp=2,
                   fsdp=True, sp=True, min_size=1 << 8, config=SEQ_EVEN)
    _assert_same_step(got, *want)


def test_zero_sharded_moments_step_matches_replicated(tiny):
    local = _local_batches(grove_config())
    want = _reference(tiny["weights"], None, _concat(local))
    got = _sharded(tiny["root"], "zero", 2, tiny["weights"], local, zero=True)
    _assert_same_step(got, *want)
