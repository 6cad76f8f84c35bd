"""The port's training driver, its checkpoints and its model directories
(grove_tpu_torch.train.driver, checkpoint.manager, api.model) against the
JAX package on the CPU, at tiny sizes:

* the CLI's flags and defaults and `build_config`;
* `CheckpointManager`: the layout, `max_to_keep`, the best checkpoint's
  marker, `latest_step` past a killed save, bit-equal restores;
* gradient accumulation (`train.step.MultiSteps`) against `optax.MultiSteps`
  over JAX's `make_optimizer` at k = 2, on the tiny model's trainable tree
  with the weights carried over: trainable parameters within rtol = atol =
  2e-3 after two updates, the same counts;
* `validate` against JAX's `validate` with one stub model on both sides
  (the same fixed boxes, objectness logits and loss): within 1e-6;
* a tiny driver run (2 epochs x 2 steps, validation), then `--auto_resume`:
  it resumes at step 4 with the saved parameters and optimizer state bit
  for bit;
* `save_pretrained` -> `from_pretrained(dir)` in bf16, quantized (int4
  LLM, calibrated W8A8 towers) and fused: the same `forward_boxes` bit for
  bit; directories the JAX package writes (a model directory, an Orbax
  log directory) load to the same state.
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig as JConfig  # noqa: E402
from grove_tpu.models.grove import init_grove_params as jinit  # noqa: E402
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch.api import GroveForCausalLM  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_reference_state_dict)
from grove_tpu_torch.checkpoint.manager import (  # noqa: E402
    CheckpointManager, to_cpu)
from grove_tpu_torch.config import GroveConfig  # noqa: E402
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.train import driver  # noqa: E402
from grove_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_parity import _perturb_zeros, port_config  # noqa: E402

ACC_TOL = 2e-3          # accumulated updates vs optax.MultiSteps
VAL_TOL = 1e-6          # validate's metrics vs JAX's


def _equal_trees(got, want, where=""):
    """Nested dicts of tensors and numbers, bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _equal_trees(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got.cpu(), want.cpu()), where
    else:
        assert got == want, where


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_parse_args_defaults_equal_original():
    from grove_tpu.train import driver as jdriver
    got, want = vars(driver.parse_args([])), vars(jdriver.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("argv", [
    [], ["--model_size", "small", "--model_max_length", "129"],
    ["--model_size", "full", "--dataset", "VidSTG", "--lora_r", "8",
     "--out_dim", "128", "--train_clip_adapters"],
    ["--dataset", "ActivityNetEntities", "--ce_loss_weight", "0.5"]])
def test_build_config_equals_original(argv):
    from grove_tpu.train import driver as jdriver
    got = driver.build_config(driver.parse_args(argv))
    want = jdriver.build_config(jdriver.parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(port_config(want))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(seed):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 4, generator=g).bfloat16(),
              "b": torch.randn(4, generator=g),
              "q": torch.randint(-8, 8, (2, 2), dtype=torch.int8)}
    opt = {"count": seed, "mu": {"w": torch.randn(3, 4, generator=g)},
           "nu": {"w": torch.rand(3, 4, generator=g)}}
    return params, opt


def test_checkpoint_manager_keeps_latest_two_and_restores_bit_equal(
        tmp_path):
    """orbax_io's semantics: `ckpt_model/<step>` with max_to_keep=2,
    `latest_step`, `restore(step=None)` = the latest; restores equal what
    was saved, even after the caller's tensors moved on."""
    mgr = CheckpointManager(str(tmp_path / "log"))
    assert mgr.latest_step() is None and mgr.restore() is None
    assert mgr.restore_best() is None and mgr.best_metric_from_marker() is None
    saved = {}
    for step in (2, 4, 6):
        params, opt = _state(step)
        mgr.save(step, params, opt, extra={"epoch": step // 2})
        saved[step] = to_cpu({"params": params, "opt_state": opt,
                              "extra": {"epoch": step // 2}})
        params["b"].add_(1.0)               # saves are copies
    assert mgr.steps() == [4, 6] and mgr.latest_step() == 6
    assert sorted(os.listdir(mgr.ckpt_dir)) == ["4", "6"]
    _equal_trees(mgr.restore(), saved[6])
    _equal_trees(mgr.restore(4), saved[4])
    # a save killed before its rename leaves a hidden directory only
    os.makedirs(os.path.join(mgr.ckpt_dir, ".tmp-x"))
    torch.save({}, os.path.join(mgr.ckpt_dir, ".tmp-x", "state.pt"))
    os.makedirs(os.path.join(mgr.ckpt_dir, "9"))     # no state file
    assert mgr.latest_step() == 6
    mgr.save(6, *_state(7))                            # replaces step 6
    assert mgr.restore(6)["opt_state"]["count"] == 7
    mgr.close()


def test_checkpoint_manager_best_and_marker(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    params, _ = _state(1)
    mgr.save_best(0, params, "metric", -0.36281)
    mgr.save_best(3, params, "metric", 0.123456)
    markers = [f for f in os.listdir(mgr.best_dir) if f.endswith(".marker")]
    assert markers == ["epoch_3_val_metric_0.1235.marker"]
    assert mgr.best_metric_from_marker() == 0.1235
    assert os.path.isdir(os.path.join(mgr.best_dir, "params"))
    _equal_trees(mgr.restore_best(), {"params": to_cpu(params)})
    assert CheckpointManager(str(tmp_path)).best_metric_from_marker() == 0.1235


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

def test_accumulation_matches_optax_multisteps():
    """Four micro-steps at k = 2 of random gradients (scales on both sides
    of the clipping norm): the port's MultiSteps over its AdamW against
    optax.MultiSteps over JAX's make_optimizer."""
    rng = np.random.default_rng(11)
    cfg = JConfig.tiny()
    _, variables = jinit(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=6, weight_decay=0.1)
    jcfg, tcfg = jstep.OptimizerConfig(**kw), tstep.OptimizerConfig(**kw)
    trainable, frozen = jstep.partition_params(
        params, jstep.trainable_mask(params, jcfg))
    jopt = optax.MultiSteps(jstep.make_optimizer(trainable, jcfg), 2)
    state = jopt.init(trainable)
    jupdate = jax.jit(jopt.update)

    model = GroveModel(port_config(cfg), device="cpu", dtype=torch.float32)
    load_reference_state_dict(model, to_torch_state_dict(params, cfg))
    tparams = tstep.partition_params(model, tstep.trainable_mask(model,
                                                                 tcfg))
    topt = tstep.MultiSteps(tstep.make_optimizer(tparams, tcfg), 2)
    zeros = jax.tree.map(jnp.zeros_like, frozen)
    for i, scale in enumerate((1e-3, 3e-2, 2e-2, 1e-4)):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32) * scale), trainable)
        upd, state = jupdate(grads, state, trainable)
        trainable = optax.apply_updates(trainable, upd)
        named = to_torch_state_dict(jstep.combine_params(grads, zeros), cfg)
        before = {n: p.detach().clone() for n, p in tparams.items()}
        for n, p in tparams.items():
            p.grad = torch.from_numpy(np.array(named[n]))
        topt.step()
        moved = [n for n, p in tparams.items()
                 if not torch.equal(p, before[n])]
        # an update every 2nd micro-step; the first at lr(0) = 0
        assert bool(moved) == (i == 3), i
        assert topt.count == (i + 1) // 2
        assert all(p.grad is None for p in tparams.values())
    want = to_torch_state_dict(jstep.combine_params(trainable, frozen), cfg)
    for n, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   rtol=ACC_TOL, atol=ACC_TOL, err_msg=n)
    assert (topt.count, topt.gradient_step, topt.mini_step) == (2, 2, 0)
    assert (int(state.gradient_step), int(state.mini_step)) == (2, 0)
    counts = [int(v) for path, v in jax.tree_util.tree_leaves_with_path(
        state.inner_opt_state) if "count" in jax.tree_util.keystr(path)]
    assert counts and set(counts) == {2}
    # the state round-trips through a checkpoint
    again = tstep.MultiSteps(tstep.make_optimizer(tparams, tcfg), 2)
    again.load_state_dict(to_cpu(topt.state_dict()))
    _equal_trees(again.state_dict(), topt.state_dict())


# ---------------------------------------------------------------------------
# validate
# ---------------------------------------------------------------------------

class _Stub:
    """One model for both packages' `validate`: fixed boxes, objectness
    logits and loss, whatever the batch."""

    def __init__(self, cfg, seed=3):
        rng = np.random.default_rng(seed)
        t, p = cfg.num_frames, cfg.max_phrases
        self.boxes = rng.uniform(0.2, 0.6, (1, t, p, 4)).astype(np.float32)
        self.logits = rng.normal(size=(1, t, p)).astype(np.float32)
        self.loss = np.float32(rng.uniform(1, 3))

    # the JAX package's `model.apply`
    def apply(self, variables, batch, method=None):
        if method.__name__ == "forward_boxes":
            return {"pred_boxes": jnp.asarray(self.boxes),
                    "objectness_logits": jnp.asarray(self.logits)}
        return {"loss": jnp.asarray(self.loss)}

    # the port's GroveModel
    def forward_boxes(self, batch):
        return {"pred_boxes": torch.from_numpy(self.boxes),
                "objectness_logits": torch.from_numpy(self.logits)}

    def forward_train(self, batch):
        return {"loss": torch.tensor(self.loss)}


@pytest.mark.parametrize("val_mode", ["giou", "loss"])
def test_validate_matches_original(tmp_path, val_mode):
    from grove_tpu.data.loader import GroundingLoader as JLoader
    from grove_tpu.text.mock_tokenizer import MockTokenizer as JTok
    from grove_tpu.train import driver as jdriver
    from grove_tpu_torch.data.loader import GroundingLoader as TLoader
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer as TTok
    from test_torch_data import _datasets
    got_ds, want_ds = _datasets("howto", tmp_path, True)
    jcfg, tcfg = JConfig.tiny(), GroveConfig.tiny()
    kw = dict(batch_size=1, shuffle=False, drop_last=False, num_workers=1)
    stub = _Stub(tcfg)
    args = argparse.Namespace(val_mode=val_mode, device="cpu")
    got = driver.validate(stub, TLoader(got_ds, TTok(), tcfg, **kw), tcfg,
                          args)
    want = jdriver.validate(stub, {}, JLoader(want_ds, JTok(), jcfg, **kw),
                            jcfg, args)
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= VAL_TOL, (k, got[k], w)
    if val_mode == "giou":
        assert 0 < got["val_obj_acc"] < 1


# ---------------------------------------------------------------------------
# the driver end to end
# ---------------------------------------------------------------------------

def _spy_steps(monkeypatch):
    """Record each run's model and optimizer, and their state before the
    run's first step."""
    runs = []
    real = driver.make_train_step

    def make(model, optimizer):
        step = real(model, optimizer)
        run = {"model": model, "opt": optimizer, "first": None}
        runs.append(run)

        def wrapped(batch):
            if run["first"] is None:
                run["first"] = (to_cpu(model.state_dict()),
                                to_cpu(optimizer.state_dict()))
            return step(batch)
        return wrapped
    monkeypatch.setattr(driver, "make_train_step", make)
    return runs


def test_driver_trains_validates_and_resumes(tmp_path, monkeypatch, capsys):
    runs = _spy_steps(monkeypatch)
    argv = ["--synthetic", "--model_size", "tiny", "--device", "cpu",
            "--steps_per_epoch", "2", "--num_workers", "1",
            "--warmup_steps", "1", "--log_base_dir", str(tmp_path),
            "--exp_name", "run"]
    best = driver.main(argv + ["--epochs", "2"])
    mgr = CheckpointManager(str(tmp_path / "run"))
    assert mgr.steps() == [2, 4]
    saved = mgr.restore(4)
    model, opt = runs[0]["model"], runs[0]["opt"]
    _equal_trees(saved["params"], model.state_dict())
    _equal_trees(saved["opt_state"], opt.state_dict())
    assert saved["opt_state"]["count"] == 4
    start = runs[0]["first"][0]
    moved = {n for n, t in start.items() if not torch.equal(t,
                                                          saved["params"][n])}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert moved and moved <= trainable
    assert mgr.best_metric_from_marker() == round(best, 4)
    out = capsys.readouterr().out
    assert "epoch 1 val: val_giou=" in out and "data_secs" in out

    driver.main(argv + ["--epochs", "3", "--auto_resume"])
    out = capsys.readouterr().out
    assert "resumed from step 4 (epoch 2)" in out
    assert "training done: 6 steps" in out
    first_params, first_opt = runs[1]["first"]
    _equal_trees(first_params, saved["params"])
    _equal_trees(first_opt, saved["opt_state"])
    assert mgr.steps() == [4, 6] and runs[1]["opt"].count == 6
    # a log directory loads as a model: its best parameters
    lm = GroveForCausalLM.from_pretrained(str(tmp_path / "run"), "tiny",
                                          dtype=torch.float32, device="cpu")
    _equal_trees(lm.model.state_dict(), mgr.restore_best()["params"])


def test_driver_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--synthetic", "--device", "cuda"])


# ---------------------------------------------------------------------------
# model directories
# ---------------------------------------------------------------------------

def _boxes_batch(cfg, seed=0):
    from grove_tpu_torch.data.collate import build_batch
    from grove_tpu_torch.text.mock_tokenizer import MockTokenizer
    rng = np.random.default_rng(seed)
    t, p = cfg.num_frames, cfg.max_phrases
    c, s = cfg.clip.image_size, cfg.sam_enc.img_size
    sample = {"frames_clip": rng.integers(0, 256, (t, c, c, 3), np.uint8),
              "frames_sam": rng.integers(0, 256, (t, s, s, 3), np.uint8),
              "caption": "a man slices bread", "tokens_positive": [(0, 5),
                                                                   (13, 18)],
              "gt_boxes": np.zeros((t, p, 4), np.float32),
              "gt_objectness": np.zeros((t, p), np.float32)}
    batch, _ = build_batch([sample], MockTokenizer(), cfg, rng)
    return batch


@pytest.mark.parametrize("kind", ["bf16", "int4_w8a8_static", "fused"])
def test_save_pretrained_round_trip(tmp_path, kind):
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    lm = GroveForCausalLM.from_pretrained(None, "tiny", dtype=dtype, seed=4,
                                          device="cpu")
    batch = _boxes_batch(lm.cfg)
    if kind == "int4_w8a8_static":
        lm.quantize(bits=4, vision=True)
        lm.calibrate(torch.from_numpy(batch["frames_clip"]),
                     torch.from_numpy(batch["frames_sam"]))
    elif kind == "fused":
        lm.fuse()
    lm.save_pretrained(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["config.json",
                                            "grove_torch_state_dict.pt"]
    back = GroveForCausalLM.from_pretrained(str(tmp_path), dtype=dtype,
                                            device="cpu")
    assert back.cfg.to_dict() == lm.cfg.to_dict()
    want_sd = lm.model.state_dict()
    _equal_trees(dict(back.model.state_dict()), dict(want_sd))
    for n, t in back.model.state_dict().items():
        assert t.stride() == want_sd[n].stride(), n
    got, want = back.forward_boxes(batch), lm.forward_boxes(batch)
    for k in ("pred_boxes", "objectness_logits"):
        assert torch.equal(got[k], want[k]), k


def test_jax_written_directories_raise(tmp_path):
    """Directories the JAX package writes load: a `save_pretrained` model
    directory and an Orbax log directory (its latest step) give the same
    state; a one-byte `flax_model.msgpack` raises ValueError (the Orbax
    reader and driver resume: tests/test_torch_orbax.py)."""
    from grove_tpu.api.model import GroveForCausalLM as JaxLM
    from grove_tpu.checkpoint.orbax_io import CheckpointManager as JaxMgr
    jcfg = JConfig.tiny()
    jmodel, variables = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    flax_dir = tmp_path / "flax"
    JaxLM(jcfg, jmodel, variables).save_pretrained(str(flax_dir))
    orbax_dir = tmp_path / "orbax"
    mgr = JaxMgr(str(orbax_dir))
    mgr.save(4, variables["params"])
    mgr.close()
    from_flax = GroveForCausalLM.from_pretrained(
        str(flax_dir), "tiny", dtype=torch.float32, device="cpu")
    from_orbax = GroveForCausalLM.from_pretrained(
        str(orbax_dir), "tiny", dtype=torch.float32, device="cpu")
    assert from_flax.cfg.to_dict() == port_config(jcfg).to_dict()
    _equal_trees(dict(from_orbax.model.state_dict()),
                 dict(from_flax.model.state_dict()))
    want = to_torch_state_dict(variables["params"], jcfg)
    assert np.array_equal(from_orbax.model.state_dict()[
        "lm_head.weight"].numpy(), np.asarray(want["lm_head.weight"]))
    (flax_dir / "flax_model.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="flax_model.msgpack"):
        GroveForCausalLM.from_pretrained(str(flax_dir), "tiny", device="cpu")
    with pytest.raises(ValueError, match="no step the port or Orbax wrote"):
        (tmp_path / "empty" / "ckpt_model" / "4" / "default").mkdir(
            parents=True)
        GroveForCausalLM.from_pretrained(str(tmp_path / "empty"), "tiny",
                                         device="cpu")
