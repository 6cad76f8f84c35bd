"""The JAX package's Orbax training runs in the port, on the CPU at tiny():
`checkpoint.orbax_read` (tensorstore), `checkpoint.manager.
CheckpointManager` seeing Orbax steps and best directories, the driver's
`--auto_resume`, the conversion CLI and `from_pretrained(log_dir)`.

The JAX `CheckpointManager` (`grove_tpu/checkpoint/orbax_io.py`) saves
step 1 of a run with the JAX driver's flags (`train.driver.build_config`,
`OptimizerConfig` as `_run` builds it) for three optimizers: optax's f32
chain, `optax.MultiSteps` over it (k = 2, after one micro-step) and
`lowmem.adamw_bf16`; the moments, counts and accumulated gradients are
seeded random values, so that each has to land where it belongs. Then:

* the port's restore equals the JAX state mapped by JAX's own
  `to_torch_state_dict` (the ConvTranspose kernels flipped) bit for bit:
  parameters, moments, counts, MultiSteps' state;
* the port driver `--auto_resume`s from the log directory and takes one
  step (step 2, epoch 1); its loss and trainable parameters are held to
  the JAX driver's step (`jax.jit(make_train_step)`, as `driver.py:362`
  builds it) from the same restored state on the batch the port's loader
  drew, within 2e-3. For `adamw_bf16` the tolerance is the same: the
  driver adds updates plainly (no stochastic rounding on its path, whose
  generator is the port's own), and the bf16 moments are rounded from the
  same fp32 math on both sides;
* `python -m grove_tpu_torch.checkpoint.orbax_read SRC DST` writes the
  port's layout, which restores bit-equal and resumes the driver to the
  same parameters;
* the best directory and its marker are honoured, and without
  tensorstore a read raises ImportError naming the conversion.
"""

import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("tensorstore")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from grove_tpu.checkpoint.orbax_io import CheckpointManager as JaxMgr  # noqa
from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.train import driver as jdriver  # noqa: E402
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch.api import GroveForCausalLM  # noqa: E402
from grove_tpu_torch.checkpoint import orbax_read  # noqa: E402
from grove_tpu_torch.checkpoint.manager import CheckpointManager  # noqa
from grove_tpu_torch.train import driver  # noqa: E402
from test_torch_driver import _equal_trees  # noqa: E402
from test_torch_parity import _perturb_zeros  # noqa: E402
from test_torch_region import UPSCALING, flip_conv_transpose  # noqa

RESUME_TOL = 2e-3
ARGV = ["--synthetic", "--model_size", "tiny", "--num_workers", "1",
        "--warmup_steps", "1", "--steps_per_epoch", "1", "--epochs", "2",
        "--lr", "1e-2", "--seed", "3"]
OPTIMIZERS = {"f32": [], "multisteps": ["--grad_accumulation_steps", "2"],
              "adamw_bf16": ["--moment_dtype", "bf16"]}


def _jax_setup(argv, model_params=None):
    """(cfg, model, params, trainable mask, optimizer) as the JAX driver's
    `_run` builds them from `argv`, the zero leaves refilled (the model
    and parameters of an earlier call with the same model flags reused)."""
    import dataclasses
    from grove_tpu.text.tokenizer import special_token_ids_from
    args = jdriver.parse_args(argv)
    cfg = jdriver.build_config(args)
    cfg = dataclasses.replace(cfg, tokens=special_token_ids_from(
        jdriver.build_tokenizer(args, cfg)))
    if model_params is None:
        model, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                             dtype=jnp.float32)
        params = _perturb_zeros(variables["params"],
                                np.random.default_rng(0))
    else:
        model, params = model_params
    ocfg = jstep.OptimizerConfig(
        lr=args.lr, betas=(args.beta1, args.beta2),
        warmup_steps=args.warmup_steps,
        total_steps=args.epochs * args.steps_per_epoch,
        grad_clip=args.grad_clip, train_mask_decoder=args.train_mask_decoder,
        freeze=not args.no_freeze, moment_dtype=args.moment_dtype,
        train_embeddings=not args.no_train_embeddings)
    optimizer = jstep.make_optimizer(params, ocfg)
    if args.grad_accumulation_steps > 1:
        optimizer = optax.MultiSteps(optimizer, args.grad_accumulation_steps)
    return cfg, model, params, jstep.trainable_mask(params, ocfg), optimizer


def _seeded_state(state, rng):
    """The optimizer state with every float leaf random (second moments
    positive) and every count 1; MultiSteps after one micro-step."""
    def f(path, x):
        name = jax.tree_util.keystr(path)    # e.g. ".inner_opt_state[1]..."
        x = np.asarray(x)
        if any(k in name for k in ("count", "mini_step", "gradient_step")):
            return jnp.asarray(1, x.dtype)
        if x.dtype.kind != "f" and x.dtype.name != "bfloat16":
            return x
        v = rng.normal(size=x.shape) * 1e-3
        if ".nu" in name:
            v = np.abs(v) * 1e-3
        return jnp.asarray(v, x.dtype)
    return jax.tree_util.tree_map_with_path(f, state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{optimizer: (log dir, JAX state)}: step 1 saved by the JAX
    CheckpointManager (the f32 run also saves its best parameters)."""
    out, shared = {}, None
    for i, (kind, extra) in enumerate(OPTIMIZERS.items()):
        cfg, model, params, mask, optimizer = _jax_setup(ARGV + extra,
                                                         shared)
        shared = (model, params)
        trainable, frozen = jstep.partition_params(params, mask)
        state = _seeded_state(optimizer.init(trainable),
                              np.random.default_rng(10 + i))
        log = str(tmp_path_factory.mktemp(kind) / "run")
        mgr = JaxMgr(log)
        mgr.save(1, params, state)
        if kind == "f32":
            mgr.save_best(0, params, "metric", 0.25)
        mgr.close()
        out[kind] = (log, {"cfg": cfg, "model": model, "params": params,
                           "mask": mask, "optimizer": optimizer,
                           "state": state})
    return out


def _prune(tree):
    """A JAX tree without its None holes (the frozen parameters')."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
        if v is not None and not (isinstance(v, dict) and not v):
            out[k] = v
    return out


def _named(tree, cfg):
    """A JAX tree under the port's names and layouts, by JAX's own
    exporter and the ConvTranspose flip."""
    sd = to_torch_state_dict(_prune(tree), cfg)
    if set(UPSCALING) <= set(sd):
        sd = flip_conv_transpose(sd)
    return {k: _tensor(np.array(v)) for k, v in sd.items()}


def _tensor(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _adam(state):
    """The Adam node of an optax state (chain or MultiSteps)."""
    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif hasattr(x, "inner_opt_state"):
            walk(x.inner_opt_state)
    walk(state)
    (adam,) = found
    return adam


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_restore_is_bit_equal(runs, kind):
    log, j = runs[kind]
    mgr = CheckpointManager(log)
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    got = mgr.restore()
    want = _named(j["params"], j["cfg"])
    _equal_trees({k: v.contiguous() for k, v in got["params"].items()}, want)
    adam = _adam(j["state"])
    opt = got["opt_state"]
    if kind == "multisteps":
        assert (opt["mini_step"], opt["gradient_step"]) == (1, 1)
        _equal_trees({k: v.contiguous() for k, v in opt["acc_grads"].items()},
                     _named(j["state"].acc_grads, j["cfg"]))
        opt = opt["inner_opt_state"]
    assert opt["count"] == int(adam.count) == 1
    for key in ("mu", "nu"):
        _equal_trees({k: v.contiguous() for k, v in opt[key].items()},
                     _named(getattr(adam, key), j["cfg"]))
    if kind == "adamw_bf16":
        assert all(v.dtype == torch.bfloat16 for v in opt["mu"].values())


def _spy(monkeypatch):
    """Record the port driver's first step: the state before it, the batch
    and the loss terms."""
    seen = {}
    real = driver.make_train_step

    def make(model, optimizer):
        step = real(model, optimizer)

        def wrapped(batch):
            from grove_tpu_torch.checkpoint.manager import to_cpu
            if "batch" not in seen:
                seen["params"] = to_cpu(model.state_dict())
                seen["opt"] = to_cpu(optimizer.state_dict())
                seen["batch"] = {k: (v.cpu().numpy() if torch.is_tensor(v)
                                     else np.asarray(v))
                                 for k, v in batch.items()}
                out = step(batch)
                seen["loss"] = {k: float(v) for k, v in out.items()}
                return out
            return step(batch)
        return wrapped
    monkeypatch.setattr(driver, "make_train_step", make)
    return seen


def _resume(monkeypatch, log, kind, capsys):
    seen = _spy(monkeypatch)
    # no TensorBoard writer (its import pulls in TensorFlow for ~10 s)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    base, name = os.path.split(log)
    driver.main(ARGV + OPTIMIZERS[kind] + [
        "--device", "cpu", "--auto_resume", "--log_base_dir", base,
        "--exp_name", name])
    out = capsys.readouterr().out
    assert "resumed from step 1 (epoch 1)" in out
    assert "training done: 2 steps" in out
    return seen, CheckpointManager(log).restore(2)


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_auto_resume_matches_the_jax_step(runs, kind, tmp_path, monkeypatch,
                                          capsys):
    src, j = runs[kind]
    log = str(tmp_path / "run")
    shutil.copytree(src, log)
    seen, saved = _resume(monkeypatch, log, kind, capsys)
    restored = CheckpointManager(src).restore(1)
    _equal_trees(seen["params"], {k: v.contiguous() for k, v in
                                  restored["params"].items()})
    # the JAX driver's step from the same state on the same batch
    trainable, frozen = jstep.partition_params(j["params"], j["mask"])
    step = jax.jit(jstep.make_train_step(j["model"], j["optimizer"]))
    batch = {k: jnp.asarray(v) for k, v in seen["batch"].items()}
    trainable, _, metrics = step(trainable, frozen, j["state"], batch)
    for key, v in metrics.items():
        assert abs(seen["loss"][key] - float(v)) <= RESUME_TOL * max(
            1.0, abs(float(v))), key
    want = _named(trainable, j["cfg"])
    for name, w in want.items():
        np.testing.assert_allclose(saved["params"][name].numpy(), w.numpy(),
                                   rtol=RESUME_TOL, atol=RESUME_TOL,
                                   err_msg=name)
    moved = [n for n, w in want.items()
             if not torch.equal(restored["params"][n].contiguous(), w)]
    if kind == "multisteps":
        assert saved["opt_state"]["mini_step"] == 0
        assert saved["opt_state"]["inner_opt_state"]["count"] == 2
    else:
        assert saved["opt_state"]["count"] == 2
    assert moved


def test_conversion_cli_resumes_the_same(runs, tmp_path, monkeypatch,
                                         capsys):
    src, _ = runs["f32"]
    dst = str(tmp_path / "converted")
    assert orbax_read.main([src, dst]) == 0
    assert "converted steps [1] and the best parameters" in \
        capsys.readouterr().out
    mgr = CheckpointManager(dst)
    assert sorted(os.listdir(mgr.ckpt_dir)) == ["1"]
    assert os.path.isfile(os.path.join(mgr.ckpt_dir, "1", "state.pt"))
    direct = CheckpointManager(src)
    _equal_trees(mgr.restore(1), jax.tree.map(
        lambda t: t.contiguous() if torch.is_tensor(t) else t,
        direct.restore(1)))
    best = direct.restore_best()["params"]
    _equal_trees(mgr.restore_best(),
                 {"params": {k: v.contiguous() for k, v in best.items()}})
    assert mgr.best_metric_from_marker() == 0.25
    a = str(tmp_path / "a" / "run")
    shutil.copytree(src, a)
    _, from_orbax = _resume(monkeypatch, a, "f32", capsys)
    _, from_converted = _resume(monkeypatch, dst, "f32", capsys)
    _equal_trees(from_converted["params"], from_orbax["params"])


def test_best_directory_and_latest(runs, tmp_path):
    """`from_pretrained(log_dir)` loads the best parameters where the run
    has them (the marker parsed), else the latest step's."""
    src, j = runs["f32"]
    mgr = CheckpointManager(src)
    assert mgr.best_metric_from_marker() == 0.25
    want = _named(j["params"], j["cfg"])
    _equal_trees({k: v.contiguous() for k, v in
                  mgr.restore_best()["params"].items()}, want)
    lm = GroveForCausalLM.from_pretrained(src, "tiny", dtype=torch.float32,
                                          device="cpu")
    _equal_trees(dict(lm.model.state_dict()), want)
    ms, _ = runs["multisteps"]
    assert CheckpointManager(ms).restore_best() is None
    lm = GroveForCausalLM.from_pretrained(ms, "tiny", dtype=torch.float32,
                                          device="cpu")
    _equal_trees(dict(lm.model.state_dict()), {
        k: v.contiguous() for k, v in
        CheckpointManager(ms).restore(1)["params"].items()})


def test_without_tensorstore_the_read_names_the_conversion(runs,
                                                           monkeypatch):
    src, _ = runs["f32"]
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    mgr = CheckpointManager(src)
    assert mgr.latest_step() == 1
    for read in (mgr.restore, mgr.restore_best):
        with pytest.raises(ImportError, match="orbax_read SRC DST"):
            read()
    with pytest.raises(ImportError, match="tensorstore"):
        GroveForCausalLM.from_pretrained(src, "tiny", device="cpu")
