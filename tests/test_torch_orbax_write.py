"""The port's training runs written as the JAX package's Orbax runs
(`grove_tpu_torch.checkpoint.orbax_write`, numpy and json alone), on the
CPU at tiny(), for the JAX driver's three optimizers (`test_torch_orbax.
OPTIMIZERS`: optax's f32 chain, `optax.MultiSteps` over it, `lowmem.
adamw_bf16`):

* (a) the writer's `_METADATA` equals the JAX `CheckpointManager.save`'s
  of the same state (every key path, key type, value type and write
  shape), and every leaf's dtype and shape equal those JAX wrote;
* (b) the JAX `CheckpointManager` finds the port's step and restores it,
  with the JAX driver's `{"params", "opt_state"}` template and without
  one, every leaf bit-equal to the JAX state;
* (c) a port driver run, its step 1 written by `save_step` and resumed by
  the JAX step (`jax.jit(make_train_step)`, as `driver.py:362` builds it)
  on the batch of the port's step 2, agrees with the port's step 2 within
  2e-3 (loss terms, trainable parameters, Adam's moments): the reverse of
  `test_torch_orbax.py::test_auto_resume_matches_the_jax_step`;
* (d) `save_best`'s directory (its `_METADATA` equal to JAX's
  `save_best`'s) and marker, read by the JAX `restore_best` /
  `best_metric_from_marker` and by the port's; extras; the two latest
  steps kept; an optimizer config the JAX driver does not build raises;
* (e) the port's `orbax_read.read_tree` reads the layout with tensorstore
  made unimportable, bit-equal;
* (f) `python -m grove_tpu_torch.checkpoint.orbax_write SRC DST [flags]`
  converts a port driver run (steps and best), which JAX restores.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("tensorstore")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.checkpoint.orbax_io import CheckpointManager as JaxMgr  # noqa
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch.checkpoint import orbax_read, orbax_write  # noqa: E402
from grove_tpu_torch.checkpoint.convert import _leaf_tensor  # noqa: E402
from grove_tpu_torch.checkpoint.manager import CheckpointManager  # noqa
from grove_tpu_torch.train import driver  # noqa: E402
from test_torch_driver import _equal_trees  # noqa: E402
from test_torch_orbax import (ARGV, OPTIMIZERS, RESUME_TOL, _adam,  # noqa
                              _jax_setup, _named, _seeded_state)

STEP_ITEM = ("ckpt_model", "1", "default")
_REAL_MAKE_TRAIN_STEP = driver.make_train_step


def _port_config(argv):
    args = driver.parse_args(argv)
    return driver.build_config(args), driver.optimizer_config(args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{optimizer: dict}: step 1 of the same state saved by the JAX
    CheckpointManager ("jax") and by `orbax_write` ("port"), the port
    state being the JAX one read by `orbax_read` (held bit-equal to it by
    `test_torch_orbax.py`); the f32 port run also has `save_best`'s
    parameters."""
    out, shared = {}, None
    for i, (kind, extra) in enumerate(OPTIMIZERS.items()):
        cfg, model, params, mask, optimizer = _jax_setup(ARGV + extra,
                                                         shared)
        shared = (model, params)
        # jax arrays, as the JAX driver holds them (the refilled zero
        # leaves are numpy arrays, which Orbax records as "np.ndarray")
        params = jax.tree.map(jnp.asarray, params)
        trainable, _ = jstep.partition_params(params, mask)
        state = _seeded_state(optimizer.init(trainable),
                              np.random.default_rng(20 + i))
        root = tmp_path_factory.mktemp(kind)
        jlog, plog = str(root / "jax"), str(root / "port")
        mgr = JaxMgr(jlog)
        mgr.save(1, params, state)
        mgr.close()
        port = CheckpointManager(jlog).restore(1)
        tcfg, ocfg = _port_config(ARGV + extra)
        n = orbax_write.save_step(plog, 1, port["params"],
                                  port["opt_state"], opt_cfg=ocfg, cfg=tcfg)
        assert n > sum(t.numel() for t in port["params"].values())
        if kind == "f32":
            orbax_write.save_best(plog, 3, port["params"], "metric", 0.25,
                                  cfg=tcfg)
        out[kind] = {"jax": jlog, "port": plog, "cfg": cfg, "model": model,
                     "params": params, "mask": mask, "optimizer": optimizer,
                     "state": state, "restored": port}
    return out


def _metadata(log):
    with open(os.path.join(log, *STEP_ITEM, orbax_read.METADATA)) as f:
        return json.load(f)


def _tensors(tree):
    """A read_tree tree with every array as a torch tensor."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return _leaf_tensor(tree).contiguous()
    return tree


def _same_leaves(got, want):
    """Two JAX trees (None holes kept) equal in structure, dtypes and
    bits."""
    is_none = lambda x: x is None  # noqa: E731
    g, gdef = jax.tree_util.tree_flatten(got, is_leaf=is_none)
    w, wdef = jax.tree_util.tree_flatten(want, is_leaf=is_none)
    assert gdef == wdef
    for a, b in zip(g, w):
        if b is None:
            assert a is None
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_metadata_equals_orbax_save(runs, kind):
    r = runs[kind]
    got, want = _metadata(r["port"]), _metadata(r["jax"])
    assert got["tree_metadata"] == want["tree_metadata"]
    assert got.pop("use_ocdbt") is False and want.pop("use_ocdbt") is True
    got.pop("tree_metadata"), want.pop("tree_metadata")
    assert got == want
    ours = _tensors(orbax_read.read_tree(os.path.join(r["port"],
                                                      *STEP_ITEM)))
    theirs = _tensors(orbax_read.read_tree(os.path.join(r["jax"],
                                                        *STEP_ITEM)))
    flat = {}

    def walk(a, b, where):
        if isinstance(b, dict):
            assert set(a) == set(b), where
            for k in b:
                walk(a[k], b[k], f"{where}/{k}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, where
            flat[where] = a
    walk(ours, theirs, "")
    assert any("count" in k for k in flat)


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_jax_restores_the_port_step(runs, kind):
    r = runs[kind]
    mgr = JaxMgr(r["port"])
    assert mgr.latest_step() == 1
    got = mgr.restore(1, {"params": r["params"], "opt_state": r["state"]})
    _same_leaves(got["params"], r["params"])
    _same_leaves(got["opt_state"], r["state"])
    bare = mgr.restore(1)              # the handler from the metadata
    _same_leaves(bare["params"], jax.tree.map(np.asarray, r["params"]))
    mgr.close()


def _spy(monkeypatch):
    """Record each step of the port driver: its batch and loss terms."""
    seen = []

    def make(model, optimizer):
        step = _REAL_MAKE_TRAIN_STEP(model, optimizer)

        def wrapped(batch):
            host = {k: (v.cpu().numpy() if torch.is_tensor(v)
                        else np.asarray(v)) for k, v in batch.items()}
            out = step(batch)
            seen.append((host, {k: float(v) for k, v in out.items()}))
            return out
        return wrapped
    monkeypatch.setattr(driver, "make_train_step", make)
    return seen


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """{optimizer: (log dir, [(batch, losses)] of its two steps)}: the
    port driver's own runs of ARGV (two epochs of one step, validation
    saving the best)."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        # no TensorBoard writer (its import pulls in TensorFlow for ~10 s)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        for kind, extra in OPTIMIZERS.items():
            seen = _spy(mp)
            log = tmp_path_factory.mktemp(f"run_{kind}")
            driver.main(ARGV + extra + [
                "--device", "cpu", "--log_base_dir", str(log),
                "--exp_name", "run"])
            assert len(seen) == 2
            out[kind] = (str(log / "run"), seen)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_jax_step_resumes_the_port_run(runs, port_runs, kind, tmp_path):
    """Step 1 of the port driver's run, written by `save_step` and
    restored by JAX, then the JAX driver's step on the batch of the port's
    step 2: loss terms, trainable parameters and Adam's moments within
    RESUME_TOL of the port's step 2."""
    r = runs[kind]
    src, seen = port_runs[kind]
    mgr = CheckpointManager(src)
    tcfg, ocfg = _port_config(ARGV + OPTIMIZERS[kind])
    one = mgr.restore(1)
    jlog = str(tmp_path / "jax")
    orbax_write.save_step(jlog, 1, one["params"], one["opt_state"],
                          opt_cfg=ocfg, cfg=tcfg)
    template = {"params": r["params"], "opt_state": r["state"]}
    state = JaxMgr(jlog).restore(1, template)
    trainable, frozen = jstep.partition_params(state["params"], r["mask"])
    step = jax.jit(jstep.make_train_step(r["model"], r["optimizer"]))
    batch = {k: jnp.asarray(v) for k, v in seen[1][0].items()}
    trainable, opt_state, metrics = step(trainable, frozen,
                                         state["opt_state"], batch)
    for key, v in metrics.items():
        assert abs(seen[1][1][key] - float(v)) <= RESUME_TOL * max(
            1.0, abs(float(v))), key
    two = mgr.restore(2)
    for name, w in _named(trainable, r["cfg"]).items():
        np.testing.assert_allclose(two["params"][name].numpy(), w.numpy(),
                                   rtol=RESUME_TOL, atol=RESUME_TOL,
                                   err_msg=name)
    opt = two["opt_state"]
    if kind == "multisteps":
        assert opt["mini_step"] == int(opt_state.mini_step) == 0
        opt = opt["inner_opt_state"]
    adam = _adam(opt_state)
    assert opt["count"] == int(adam.count) == (1 if kind == "multisteps"
                                               else 2)
    for key in ("mu", "nu"):
        want = _named(getattr(adam, key), r["cfg"])
        assert set(opt[key]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(opt[key][name].float().numpy(),
                                       w.float().numpy(), rtol=RESUME_TOL,
                                       atol=RESUME_TOL, err_msg=name)


def _to_bf16(tree):
    """A port state with every float tensor rounded to bf16 (the card's)."""
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(torch.bfloat16)
    return tree


def _rounded(tree):
    """A JAX state with every float leaf rounded through bf16, in its dtype."""
    return jax.tree.map(
        lambda x: (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(x.dtype))
                   if jnp.issubdtype(x.dtype, jnp.floating)
                   else np.asarray(x)), tree)


def test_bf16_state_restores_into_the_fp32_template(runs, tmp_path):
    """A bf16 port state (the card's: parameters, moments and accumulated
    gradients) is written in bf16, not in the JAX driver's dtypes, and
    restores into the JAX driver's `{"params", "opt_state"}` template by
    Orbax's cast: for each optimizer, every leaf in the template's dtype
    (fp32 parameters and moments, adamw_bf16's bf16 moments, int32
    counts) holding the bf16 values exactly."""
    for kind, extra in OPTIMIZERS.items():
        r = runs[kind]
        tcfg, ocfg = _port_config(ARGV + extra)
        log = str(tmp_path / kind)
        orbax_write.save_step(log, 5, _to_bf16(r["restored"]["params"]),
                              _to_bf16(r["restored"]["opt_state"]),
                              opt_cfg=ocfg, cfg=tcfg)
        floats = []

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            elif torch.is_tensor(t) or isinstance(t, np.ndarray):
                if t.dtype not in (np.int32, np.int64, torch.int32):
                    floats.append(t.dtype)
        walk(orbax_read.read_tree(os.path.join(log, "ckpt_model", "5",
                                               "default")))
        assert floats and set(floats) == {torch.bfloat16}, set(floats)
        got = JaxMgr(log).restore(5, {"params": r["params"],
                                      "opt_state": r["state"]})
        _same_leaves(got["params"], _rounded(r["params"]))
        _same_leaves(got["opt_state"], _rounded(r["state"]))


def test_extras_restore_in_both_packages(runs, tmp_path):
    """`extra` (Python numbers and a tensor): `_METADATA` entries equal to
    JAX's own save of the same extras, read back by both packages."""
    r = runs["f32"]
    ema = np.arange(6, dtype=np.float32).reshape(2, 3)
    port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    orbax_write.save_step(port, 7, r["restored"]["params"],
                          extra={"epoch": 3, "lr": 0.5,
                                 "ema": torch.from_numpy(ema)},
                          cfg=_port_config(ARGV)[0])
    mgr = JaxMgr(jax_)
    mgr.save(7, r["params"], extra={"epoch": 3, "lr": 0.5,
                                    "ema": jnp.asarray(ema)})
    mgr.close()

    def extras(log):
        with open(os.path.join(log, "ckpt_model", "7", "default",
                               orbax_read.METADATA)) as f:
            return {k: v for k, v in json.load(f)["tree_metadata"].items()
                    if k.startswith("('extra'")}
    assert extras(port) == extras(jax_) and len(extras(port)) == 3
    got = JaxMgr(port).restore(7)["extra"]
    assert (got["epoch"], got["lr"]) == (3, 0.5)
    np.testing.assert_array_equal(np.asarray(got["ema"]), ema)
    got = CheckpointManager(port).restore(7)["extra"]
    assert (got["epoch"], got["lr"]) == (3, 0.5)
    np.testing.assert_array_equal(got["ema"].numpy(), ema)


def test_latest_steps_kept_and_unknown_optimizer_raises(runs, tmp_path):
    """Three saves keep the two latest steps, which JAX lists too; an
    optimizer config the JAX driver does not build raises, naming it."""
    import dataclasses
    r = runs["f32"]
    tcfg, ocfg = _port_config(ARGV)
    log = str(tmp_path / "run")
    for step in (1, 2, 3):
        orbax_write.save_step(log, step, r["restored"]["params"], cfg=tcfg)
    assert CheckpointManager(log).steps() == [2, 3]
    assert JaxMgr(log).latest_step() == 3
    assert not [d for d in os.listdir(os.path.join(log, "ckpt_model"))
                if d.startswith(".")]
    with pytest.raises(ValueError, match="'f16'"):
        orbax_write.save_step(log, 4, r["restored"]["params"],
                              r["restored"]["opt_state"], cfg=tcfg,
                              opt_cfg=dataclasses.replace(
                                  ocfg, moment_dtype="f16"))
    assert CheckpointManager(log).steps() == [2, 3]


def test_best_is_read_by_both_managers(runs, tmp_path):
    r = runs["f32"]
    best = os.path.join(r["port"], "ckpt_model_best")
    jmgr = JaxMgr(str(tmp_path / "jax"))
    jmgr.save_best(3, r["params"], "metric", 0.25)
    jmgr.close()

    def tree_metadata(log):
        with open(os.path.join(log, "ckpt_model_best", "params",
                               orbax_read.METADATA)) as f:
            return json.load(f)["tree_metadata"]
    assert tree_metadata(r["port"]) == tree_metadata(str(tmp_path / "jax"))
    assert sorted(f for f in os.listdir(best) if f.endswith(".marker")) == [
        "epoch_3_val_metric_0.2500.marker"]
    jmgr = JaxMgr(r["port"])
    assert jmgr.best_metric_from_marker() == 0.25
    _same_leaves(jmgr.restore_best({"params": r["params"]})["params"],
                 r["params"])
    jmgr.close()
    mgr = CheckpointManager(r["port"])
    assert mgr.best_metric_from_marker() == 0.25
    want = {k: v.contiguous() for k, v in r["restored"]["params"].items()}
    _equal_trees({k: v.contiguous() for k, v in
                  mgr.restore_best()["params"].items()}, want)
    # a second save replaces the directory and the marker
    orbax_write.save_best(r["port"], 4, r["restored"]["params"], "metric",
                          0.5, cfg=_port_config(ARGV)[0])
    assert mgr.best_metric_from_marker() == 0.5
    assert [f for f in os.listdir(best) if f.endswith(".marker")] == [
        "epoch_4_val_metric_0.5000.marker"]


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_read_without_tensorstore(runs, kind, monkeypatch):
    r = runs[kind]
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    got = CheckpointManager(r["port"]).restore(1)
    want = r["restored"]

    def contiguous(tree):
        if isinstance(tree, dict):
            return {k: contiguous(v) for k, v in tree.items()}
        return tree.contiguous() if torch.is_tensor(tree) else tree
    _equal_trees(contiguous(got), contiguous(want))
    with pytest.raises(ImportError, match="orbax_read SRC DST"):
        CheckpointManager(r["jax"]).restore(1)


def test_cli_converts_a_port_run(runs, port_runs, tmp_path, capsys):
    r = runs["f32"]
    src, _ = port_runs["f32"]
    dst = str(tmp_path / "jax")
    assert orbax_write.main([src, dst] + ARGV) == 0
    assert "converted steps [1, 2] and the best parameters" in \
        capsys.readouterr().out
    mgr, jmgr = CheckpointManager(src), JaxMgr(dst)
    assert jmgr.latest_step() == 2
    got = jmgr.restore(2, {"params": r["params"], "opt_state": r["state"]})
    two = mgr.restore(2)
    _equal_trees(_named(got["params"], r["cfg"]),
                 {k: v.contiguous() for k, v in two["params"].items()})
    assert int(_adam(got["opt_state"]).count) == two["opt_state"]["count"]
    best = jmgr.restore_best({"params": r["params"]})["params"]
    _equal_trees(_named(best, r["cfg"]), {
        k: v.contiguous() for k, v in mgr.restore_best()["params"].items()})
    assert jmgr.best_metric_from_marker() == mgr.best_metric_from_marker()
    jmgr.close()
