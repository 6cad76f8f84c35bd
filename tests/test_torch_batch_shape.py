"""How far bf16 moves the training step's gradients, in the port and in the
JAX package, on the CPU at a tiny config (`test_torch_train._slice_config`:
K1, K2, K4 and their backwards on the path), the same seeded weights in
both packages and one 2-row batch made from a seed with numpy.

* bf16 against fp32: each package's trainable gradients of the 2-row step
  with the weights rounded to bf16 (the model computing in bf16) against
  the same step in fp32, per tensor as the max-abs distance relative to
  the fp32 gradient's max-abs (or to GRAD_FLOOR of the largest one). The
  port's largest distance must be at most SAME_ORDER times the JAX
  package's; each package's worst tensors are printed beside the other
  package's distance for the same tensor (JAX's gradients under the
  port's names, through `to_torch_state_dict`).
* The same with every ReLU's mask pinned to the fp32 step's signs in both
  packages (`flax.linen.relu` and `torch.nn.functional.relu` replaced by
  x times the fp32 forward's x > 0, call by call): a pre-activation that
  bf16 moves across zero switches its whole gradient on or off, which
  makes one tensor's distance a matter of which element flipped. Pinned,
  the port's largest distance must again be at most SAME_ORDER times the
  JAX package's.
* The batch's shape: the port's batched step against the same step a row
  at a time (`train.step.row_at_a_time`, the arithmetic of the pipeline's
  ranks), and the JAX package's jitted step with the batch sharded one row
  a device over a ("data",) mesh of 2 CPU devices against the unsharded
  step. In fp32 each within ROWS_TOL of max-abs; in bf16 both distances
  are printed and held to nothing (XLA on the CPU may round a sharded row
  as it rounds a batched one).
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.data.collate import build_batch  # noqa: E402
from grove_tpu.models.grove import GroveModel as JaxGrove  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.text.mock_tokenizer import MockTokenizer  # noqa: E402
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_reference_state_dict)
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_parity import _perturb_zeros, port_config  # noqa: E402
from test_torch_train import _slice_config  # noqa: E402

SAME_ORDER = 4.0         # the port's bf16 error at most this times JAX's
ROWS_TOL = 1e-4          # fp32 batch-shape distance, of max-abs
GRAD_FLOOR = 1e-3        # a gradient's scale: at least this of the largest
ROWS = (("a man slices bread on a wooden board", [(0, 5), (13, 18), (22, 36)],
         0.7), ("a dog runs", [(0, 5)], 0.3))


def _batch(cfg):
    """Two rows with different captions, phrases, boxes and visibility."""
    samples = []
    for i, (caption, spans, visible) in enumerate(ROWS):
        rng = np.random.default_rng(10 + i)
        t, p = cfg.num_frames, cfg.max_phrases
        c, s = cfg.clip.image_size, cfg.sam_enc.img_size
        samples.append({
            "frames_clip": rng.integers(0, 256, (t, c, c, 3), np.uint8),
            "frames_sam": rng.integers(0, 256, (t, s, s, 3), np.uint8),
            "caption": caption, "tokens_positive": spans,
            "gt_boxes": rng.uniform(0.2, 0.6, (t, p, 4)).astype(np.float32),
            "gt_objectness": (rng.uniform(size=(t, p)) < visible).astype(
                np.float32)})
    batch, _ = build_batch(samples, MockTokenizer(), cfg,
                           np.random.default_rng(2))
    return batch


def _distance(got, want):
    """Per tensor, max |got - want| over max(max |want|, GRAD_FLOOR x the
    largest max |want|), as (name, distance) worst first."""
    top = max(float(np.abs(w).max()) for w in want.values())
    dist = {n: float(np.abs(got[n].astype(np.float32)
                            - w.astype(np.float32)).max())
            / max(float(np.abs(w).max()), GRAD_FLOOR * top)
            for n, w in want.items()}
    return sorted(dist.items(), key=lambda kv: -kv[1])


def _prune(tree):
    """A JAX tree without its None holes (the frozen parameters')."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
        if v is not None and not (isinstance(v, dict) and not v):
            out[k] = v
    return out


def _jax_grads(cfg, params, batch, dtype, mesh=None):
    """The trainable gradients of `make_train_step`'s loss (`step.py:142`)
    with the model computing in `dtype` on `params` cast to it, under the
    port's names (`to_torch_state_dict`); the batch sharded a row a device
    over `mesh` when given."""
    model = JaxGrove(cfg, dtype=dtype)
    params = jax.tree.map(lambda x: jnp.asarray(x, dtype), params)
    trainable, frozen = jstep.partition_params(
        params, jstep.trainable_mask(params, jstep.OptimizerConfig()))

    def loss_fn(tr, fr, b):
        out = model.apply({"params": jstep.combine_params(tr, fr)}, b,
                          method=JaxGrove.forward_train)
        return out["loss"], out

    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh is not None:
        rows, whole = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
        batch = {k: jax.device_put(v, rows) for k, v in batch.items()}
        trainable, frozen = jax.device_put((trainable, frozen), whole)
    grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(trainable, frozen,
                                                        batch)
    grads = jax.tree.map(lambda g: np.asarray(g.astype(jnp.float32)), grads)
    return {k: np.asarray(v)
            for k, v in to_torch_state_dict(_prune(grads), cfg).items()}


def _port_batched(model, host_batch):
    """The port's trainable gradients of the batched step, as fp32 numpy
    arrays by name."""
    params = tstep.partition_params(model, tstep.trainable_mask(
        model, tstep.OptimizerConfig(warmup_steps=1)))
    model.forward_train(tstep.batch_to_device(host_batch, "cpu"))[
        "loss"].backward()
    batched = {n: p.grad.float().numpy() for n, p in params.items()
               if p.grad is not None}
    for p in params.values():
        p.grad = None
    return batched


def _port_grads(model, host_batch):
    """The port's trainable gradients of the batched step and of the same
    step a row at a time, as fp32 numpy arrays by name."""
    batched = _port_batched(model, host_batch)
    _, rows = tstep.row_at_a_time(model, host_batch)
    return batched, {n: g.float().numpy() for n, g in rows.items()}


@pytest.fixture(scope="module")
def setup():
    """(config, the JAX parameters, the 2-row batch)."""
    cfg = dataclasses.replace(_slice_config(), max_seq_len=121)
    _, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                     dtype=jnp.float32)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    batch = _batch(cfg)
    assert batch["input_ids"].shape == (2, 128)
    return cfg, params, batch


@pytest.fixture(scope="module")
def grads(setup):
    """{(package, dtype): (batched, rows or sharded) gradients}."""
    cfg, params, batch = setup
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    sd = to_torch_state_dict(params, cfg)
    out = {}
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        out["jax", name] = (_jax_grads(cfg, params, batch, jdt),
                            _jax_grads(cfg, params, batch, jdt, mesh))
        model = GroveModel(port_config(cfg), device="cpu", dtype=tdt)
        load_reference_state_dict(model, sd)
        out["port", name] = _port_grads(model, batch)
    return out


class _Pins:
    """ReLU replaced call by call: "record" keeps each call's x > 0 (from
    concrete or traced values), "pin" returns x times the recorded mask of
    the same call, so the gradient takes the recorded sign pattern."""

    def __init__(self, relu, mask):
        self.relu, self.mask, self.masks, self.mode, self.i = relu, mask, \
            [], None, 0

    def __call__(self, x, *a, **kw):
        if self.mode == "record":
            self.masks.append(x > 0)
        elif self.mode == "pin":
            m = self.masks[self.i]
            self.i += 1
            assert tuple(m.shape) == tuple(x.shape), (m.shape, x.shape)
            return x * self.mask(m, x)
        return self.relu(x)


@pytest.fixture(scope="module")
def pinned(setup):
    """{(package, dtype): the batched step's gradients} with every ReLU's
    mask pinned to that package's fp32 step."""
    import flax.linen as fnn
    import torch.nn.functional as F
    cfg, params, batch = setup
    sd = to_torch_state_dict(params, cfg)
    jpins = _Pins(fnn.relu, lambda m, x: jnp.asarray(m, x.dtype))
    tpins = _Pins(torch.relu, lambda m, x: m.to(x.dtype))
    jmodel = JaxGrove(cfg, dtype=jnp.float32)

    def record(p, b):
        jmodel.apply({"params": p}, b, method=JaxGrove.forward_train)
        return list(jpins.masks)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "relu", jpins)
        mp.setattr(F, "relu", tpins)
        jpins.mode = "record"
        masks = jax.jit(record)(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        jpins.masks = [np.asarray(m) for m in masks]
        assert jpins.masks
        jpins.mode = tpins.mode = "pin"
        for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                               ("bf16", jnp.bfloat16, torch.bfloat16)):
            jpins.i = 0
            out["jax", name] = _jax_grads(cfg, params, batch, jdt)
            assert jpins.i == len(jpins.masks)
            # F.relu is bound when a model is built (MLPBlock's act)
            model = GroveModel(port_config(cfg), device="cpu", dtype=tdt)
            load_reference_state_dict(model, sd)
            if name == "fp32":
                tpins.mode = "record"
                with torch.no_grad():
                    model.forward_train(tstep.batch_to_device(batch, "cpu"))
                tpins.mode = "pin"
                assert len(tpins.masks) == len(jpins.masks)
            tpins.i = 0
            out["port", name] = _port_batched(model, batch)
            assert tpins.i == len(tpins.masks)
    return out


def _same_order(found, what):
    """Print each package's worst tensors beside the other's distance for
    the same tensor; assert the port's largest at most SAME_ORDER x JAX's."""
    other = {"jax": "port", "port": "jax"}
    for pkg, d in found.items():
        theirs = dict(found[other[pkg]])
        print(f"{pkg} ({what}): bf16 vs fp32 gradients of the 2-row step, "
              f"{len(d)} tensors, worst (name, {pkg}, {other[pkg]}): "
              f"{[(n, v, theirs.get(n)) for n, v in d[:5]]}")
        sys.stdout.flush()
    assert found["port"] and found["jax"]
    assert found["port"][0][1] <= SAME_ORDER * found["jax"][0][1], found


def test_port_bf16_error_is_of_the_jax_packages_order(grads):
    """The 2-row step's bf16 gradients against its fp32 ones: the port's
    largest per-tensor distance at most SAME_ORDER x the JAX package's."""
    found = {}
    for pkg in ("jax", "port"):
        bf16, fp32 = grads[pkg, "bf16"][0], grads[pkg, "fp32"][0]
        assert set(bf16) == set(fp32)
        found[pkg] = _distance(bf16, fp32)
    assert set(grads["port", "fp32"][0]) <= set(grads["jax", "fp32"][0])
    _same_order(found, "free")


def test_port_bf16_error_with_relu_pinned(pinned):
    """With every ReLU's mask pinned to the fp32 step's, the port's largest
    per-tensor bf16 distance at most SAME_ORDER x the JAX package's."""
    _same_order({pkg: _distance(pinned[pkg, "bf16"], pinned[pkg, "fp32"])
                 for pkg in ("jax", "port")}, "ReLU pinned")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_batch_shape_distance(grads, dtype):
    """The batched step against the port's step a row at a time and the
    JAX step sharded a row a device: within ROWS_TOL in fp32; in bf16
    both distances printed."""
    found = {pkg: _distance(grads[pkg, dtype][1], grads[pkg, dtype][0])
             for pkg in ("jax", "port")}
    for pkg, d in found.items():
        print(f"{pkg} {dtype}: batch-shape distance, {len(d)} tensors, "
              f"worst {d[:3]}")
    if dtype == "fp32":
        for pkg, d in found.items():
            assert d[0][1] <= ROWS_TOL, (pkg, d[:3])
