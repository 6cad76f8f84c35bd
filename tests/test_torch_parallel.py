"""The port's parallel rules and GPipe pipeline (grove_tpu_torch.parallel)
against the JAX package's, on the CPU, in one process.

* The rules: every parameter of `GroveConfig.tiny()` and `small()` gets
  the placements of the JAX package's `params_shardings`, `zero_sharding`
  and `fsdp_shardings` specs, their dims carried through
  `to_torch_state_dict` (a Linear's (in, out) kernel is the (out, in)
  weight, a conv's (kh, kw, in, out) the (out, in, kh, kw) one), over the
  (data, model) meshes (1, 2), (2, 2) and (4, 1). The JAX side runs on the
  8 CPU devices of the test conftest; the port's rules need no process
  group (a mesh given as its axis sizes).
* The pipeline: `stack_block_params` / `unstack_block_params` round-trip;
  `pipelined_llama_forward` equals the JAX `pipelined_llama_forward` on the
  same weights at (stages, microbatches) = (2, 4), (4, 4) and (4, 8)
  within rtol = atol = 2e-3 (the parity suite's), and the port's own
  sequential `LlamaModel` within 1e-5; its gradients, and with `remat`,
  equal the sequential ones within 1e-5.
* The pipelined step: `make_pipelined_train_step` (2 stages, both on the
  CPU) equals `make_train_step` on the tiny model (loss within 1e-5
  relative, every trainable gradient within 1e-4), and its loss equals the
  JAX `make_pipelined_train_step` on a 2-stage CPU mesh within 2e-3
  relative; also on uint8 SAM frames with `sam_valid_hw`
  (`tests/test_pipeline_parallel.py:144`).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grove_tpu.checkpoint.torch_convert import to_torch_state_dict  # noqa
from grove_tpu.config import GroveConfig, LlamaConfig  # noqa: E402
from grove_tpu.models.grove import init_grove_params  # noqa: E402
from grove_tpu.models.llama import LlamaModel as JaxLlama  # noqa: E402
from grove_tpu.parallel import pipeline as jpipe  # noqa: E402
from grove_tpu.parallel import sharding as jshard  # noqa: E402
from grove_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from grove_tpu.train import step as jstep  # noqa: E402
from grove_tpu_torch.checkpoint.convert import (  # noqa: E402
    load_reference_state_dict)
from grove_tpu_torch.models.grove import GroveModel  # noqa: E402
from grove_tpu_torch.models.llama import LlamaModel  # noqa: E402
from grove_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from grove_tpu_torch.parallel import sharding as tshard  # noqa: E402
from grove_tpu_torch.parallel.dryrun import dummy_batch  # noqa: E402
from grove_tpu_torch.train import step as tstep  # noqa: E402
from test_torch_parity import _perturb_zeros, port_config  # noqa: E402

TOL = 2e-3               # port vs JAX (the parity suite's)
SEQ_TOL = 1e-5           # pipelined vs the port's sequential pass, fp32
GRAD_TOL = 1e-4          # pipelined vs sequential step gradients, fp32
PRIMES = (2, 3, 5, 7, 11, 13)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def _dim_maps(shapes, cfg):
    """JAX path -> (reference name, torch dim -> JAX dim) through
    `to_torch_state_dict`, read from a probe tree: leaf k holds
    k * 10**6 + arange over dims of distinct prime sizes."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    probes = [(k * 10 ** 6 + np.arange(np.prod(PRIMES[:len(v.shape)])))
              .reshape(PRIMES[:len(v.shape)]).astype(np.float64)
              for k, (_, v) in enumerate(leaves)]
    mapped = to_torch_state_dict(
        jax.tree_util.tree_unflatten(treedef, probes), cfg)
    out = {}
    for name, arr in mapped.items():
        k = int(np.asarray(arr).reshape(-1)[0]) // 10 ** 6
        path = jshard.path_str(leaves[k][0])
        ndim = len(leaves[k][1].shape)
        perm = {e: PRIMES.index(n) for e, n in enumerate(np.shape(arr))
                if n in PRIMES[:ndim]}
        out[path] = (name, perm)
    return out


def _expected(spec, perm):
    """The JAX spec (over JAX dims) as port placements (over torch
    dims)."""
    from torch.distributed.tensor import Replicate, Shard
    inv = {d: e for e, d in perm.items()}
    out = []
    for ax in ("data", "model"):
        dims = [d for d, a in enumerate(tuple(spec)) if a == ax]
        out.append(Shard(inv[dims[0]]) if dims else Replicate())
    return tuple(out)


@pytest.fixture(scope="module", params=["tiny", "small"])
def trees(request):
    """(JAX config, JAX parameter shapes, JAX path -> (name, dim map), the
    port's parameter shapes by name)."""
    cfg = getattr(GroveConfig, request.param)()
    shapes = jax.eval_shape(
        lambda k: init_grove_params(cfg, k, dtype=jnp.float32)[1]["params"],
        jax.random.PRNGKey(0))
    port = GroveModel(port_config(cfg), device="meta", dtype=torch.float32)
    return cfg, shapes, _dim_maps(shapes, cfg), port


MESHES = [(1, 2), (2, 2), (4, 1)]
RULES = {
    "params": (jshard.params_shardings, tshard.params_shardings, {}),
    "zero": (jshard.zero_sharding, tshard.zero_sharding, {}),
    "fsdp": (jshard.fsdp_shardings, tshard.fsdp_shardings, {}),
    "fsdp_min256": (jshard.fsdp_shardings, tshard.fsdp_shardings,
                    {"min_size": 1 << 8}),
}


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("data,model", MESHES)
def test_placements_match_jax_specs(trees, rule, data, model):
    cfg, shapes, maps, port = trees
    jfn, tfn, kw = RULES[rule]
    mesh = jax_mesh(data=data, model=model,
                    devices=jax.devices()[:data * model])
    jspecs = jfn(shapes, mesh, **kw)
    got = tfn(port, {"data": data, "model": model}, **kw)
    flat = jax.tree_util.tree_flatten_with_path(jspecs)[0]
    want = {}
    for path, sharding in flat:
        p = jshard.path_str(path)
        if p in maps:
            name, perm = maps[p]
            want[name] = _expected(sharding.spec, perm)
    assert set(want) == set(got)
    sharded = 0
    for name in want:
        assert got[name] == want[name], (name, got[name], want[name])
        sharded += any(type(pl).__name__ == "Shard" for pl in want[name])
    assert sharded > 0


def test_activation_placements_match_jax():
    """`replicated`, `data_sharded` and `sequence_parallel_sharding` are
    the placements of JAX's `P()`, `P("data")` and `P("data", "model",
    None)` (activations keep their layout: no dim map)."""
    from grove_tpu.parallel import mesh as jmesh
    from grove_tpu_torch.parallel import mesh as tmesh
    mesh = jax_mesh(data=2, model=2, devices=jax.devices()[:4])
    same = {0: 0, 1: 1, 2: 2}
    assert tmesh.replicated(None) == _expected(jmesh.replicated(mesh).spec,
                                               same)
    assert tmesh.data_sharded(None, 3) == _expected(
        jmesh.data_sharded(mesh, 3).spec, same)
    assert tshard.sequence_parallel_sharding(None) == _expected(
        jshard.sequence_parallel_sharding(mesh).spec, same)


def test_rules_drop_specs_that_do_not_divide():
    """`partition_spec_for` drops a spec whose mesh size does not divide the
    dim (the tiny vocabulary of 135 over model = 2), as JAX."""
    assert tshard.partition_spec_for("model.embed_tokens.weight", (135, 32),
                                     mesh={"model": 2}) == ()
    assert tshard.partition_spec_for("model.embed_tokens.weight", (136, 32),
                                     mesh={"model": 2}) == ("model", None)
    assert tshard.partition_spec_for("model.layers.0.self_attn.qkv_proj."
                                     "weight", (96, 32)) == ()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

LLAMA = LlamaConfig(vocab_size=128, extra_vocab_size=7, hidden_size=32,
                    intermediate_size=64, num_layers=4, num_heads=4,
                    num_kv_heads=4, max_position_embeddings=512)


@pytest.fixture(scope="module")
def stack():
    """The JAX LLaMA stack of `tests/test_pipeline_parallel.py` and its
    port twin on the same weights, an input and positions."""
    rng = np.random.default_rng(0)
    b, s = 8, 6
    x = rng.normal(size=(b, s, LLAMA.hidden_size)).astype(np.float32)
    positions = np.arange(s)
    jmodel = JaxLlama(LLAMA, dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(positions))["params"]
    params = _perturb_zeros(params, rng)
    sd = {k[len("model."):]: v for k, v in to_torch_state_dict(
        {"llama": params}, GroveConfig.tiny()).items()}
    port = LlamaModel(port_config(LLAMA), device="cpu", dtype=torch.float32)
    sd["embed_tokens.weight"] = port.embed_tokens.weight.detach().numpy()
    port.load_state_dict({k: torch.as_tensor(np.asarray(v))
                          for k, v in sd.items()})
    return jmodel, params, port, x, positions


def test_stack_roundtrip(stack):
    _, _, port, _, _ = stack
    stacked, rest = tpipe.stack_block_params(port, LLAMA.num_layers)
    assert set(rest) == {"embed_tokens.weight", "norm.weight"}
    assert stacked["self_attn.q_proj.weight"].shape[0] == LLAMA.num_layers
    back = tpipe.unstack_block_params(stacked, LLAMA.num_layers)
    sd = port.state_dict()
    assert set(back) | set(rest) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def _pipe(n):
    return tpipe.make_pipe_mesh(n, ["cpu"] * n)


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 4), (4, 8)])
def test_pipelined_forward_matches_jax(stack, n_stages, n_micro):
    jmodel, params, port, x, positions = stack
    mesh = jpipe.make_pipe_mesh(n_stages)
    want = jax.jit(lambda p, h: jpipe.pipelined_llama_forward(
        LLAMA, p, h, jnp.asarray(positions), mesh, n_micro,
        dtype=jnp.float32))(params, jnp.asarray(x))
    xt, pos = torch.as_tensor(x), torch.as_tensor(positions)
    with torch.no_grad():
        got = tpipe.pipelined_llama_forward(copy.deepcopy(port), xt, pos,
                                            _pipe(n_stages), n_micro)
        seq = port(xt, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=SEQ_TOL,
                               atol=SEQ_TOL)


def _grads(port, fn):
    model = copy.deepcopy(port)
    fn(model).pow(2).sum().backward()
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_grads_match_sequential(stack, remat):
    _, _, port, x, positions = stack
    xt, pos = torch.as_tensor(x), torch.as_tensor(positions)
    want = _grads(port, lambda m: m(xt, pos))

    def pipelined(m):
        m.remat = remat
        return tpipe.pipelined_llama_forward(
            m, xt, pos, _pipe(4 if not remat else 2), 4)
    got = _grads(port, pipelined)
    assert set(got) == set(want) and len(want) == 9 * LLAMA.num_layers + 1
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   rtol=SEQ_TOL, atol=SEQ_TOL, err_msg=n)


def test_pipeline_refuses_bad_splits(stack):
    _, _, port, x, positions = stack
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipelined_llama_forward(port, torch.as_tensor(x),
                                      torch.as_tensor(positions), _pipe(2), 3)
    with pytest.raises(ValueError, match="stages"):
        tpipe.pipelined_llama_forward(port, torch.as_tensor(x),
                                      torch.as_tensor(positions), _pipe(3), 2)
    with pytest.raises(ValueError, match="devices"):
        tpipe.make_pipe_mesh(3, ["cpu", "cpu"])


# ---------------------------------------------------------------------------
# the pipelined step
# ---------------------------------------------------------------------------

def _uint8_sam(cfg, batch, rng):
    s = cfg.sam_enc.img_size
    batch = dict(batch)
    b = len(batch["input_ids"])
    batch["frames_sam"] = rng.integers(0, 256, (b, cfg.num_frames, s, s, 3),
                                       np.uint8)
    batch["sam_valid_hw"] = np.array([[s, s // 2], [s // 2, s]] * (b // 2),
                                     np.int32)
    return batch


@pytest.fixture(scope="module")
def tiny():
    cfg = GroveConfig.tiny()
    jmodel, variables = init_grove_params(cfg, jax.random.PRNGKey(0),
                                          dtype=jnp.float32, batch=4)
    params = _perturb_zeros(variables["params"], np.random.default_rng(0))
    return cfg, jmodel, params


@pytest.mark.parametrize("valid_hw", [False, True])
def test_pipelined_step_matches_sequential_and_jax(tiny, valid_hw):
    cfg, jmodel, params = tiny
    rng = np.random.default_rng(3)
    batch = dummy_batch(cfg, 4, rng)
    if valid_hw:
        batch = _uint8_sam(cfg, batch, rng)
    jcfg = jstep.OptimizerConfig(total_steps=10, warmup_steps=2,
                                 full_llm=True)
    opt = jstep.make_optimizer(params, jcfg)
    trainable, frozen = jstep.partition_params(
        params, jstep.trainable_mask(params, jcfg))
    _, _, jm = jax.jit(jstep.make_pipelined_train_step(
        jmodel, opt, jpipe.make_pipe_mesh(2), 2))(
            trainable, frozen, opt.init(trainable),
            {k: jnp.asarray(v) for k, v in batch.items()})

    ocfg = tstep.OptimizerConfig(total_steps=10, warmup_steps=2,
                                 full_llm=True)
    base = GroveModel(port_config(cfg), device="cpu", dtype=torch.float32)
    load_reference_state_dict(base, to_torch_state_dict(params, cfg))
    runs = {}
    for name in ("sequential", "pipelined"):
        model = copy.deepcopy(base)
        tp = tstep.partition_params(model, tstep.trainable_mask(model, ocfg))
        opt_t = tstep.make_optimizer(tp, ocfg)
        if name == "pipelined":
            pipe = _pipe(2)
            tpipe.place_stages(model.model, pipe)
            step = tstep.make_pipelined_train_step(model, opt_t, pipe, 2)
        else:
            step = tstep.make_train_step(model, opt_t)
        out = step(tstep.batch_to_device(batch, "cpu"))
        runs[name] = ({k: float(v) for k, v in out.items()},
                      {n: p.grad for n, p in tp.items()})
    (lseq, gseq), (lpp, gpp) = runs["sequential"], runs["pipelined"]
    for k in lseq:
        assert abs(lpp[k] - lseq[k]) <= 1e-5 * max(1.0, abs(lseq[k])), k
    assert abs(lpp["loss"] - float(jm["loss"])) <= TOL * abs(lpp["loss"])
    moved = 0
    for n, g in gseq.items():
        if g is None:
            assert gpp[n] is None, n
            continue
        moved += 1
        np.testing.assert_allclose(gpp[n].numpy(), g.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=n)
    assert moved > 0
